"""Seismic fit plots (copied from ``beat_tpu/plotting/seismic.py``;
reference ``beat/plotting/seismic.py``)."""

from __future__ import annotations

import numpy as np

from beat_tpu_torch.plotting.common import PlotOptions, format_axes, save_figure


def _map_point(problem, po):
    from beat_tpu_torch.backend import SampleStage

    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    trace = handler.load_trace(po.load_stage)
    pop, llks = trace.end_points()
    return problem.ordering.to_point(pop[int(np.argmax(llks))])


def _posterior_draws(problem, po, n_draws):
    """Random posterior points for fuzzy plot ensembles."""
    from beat_tpu_torch.backend import SampleStage

    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    trace = handler.load_trace(po.load_stage)
    flat = trace.q_trace.reshape(-1, trace.q_trace.shape[-1])
    rng = np.random.default_rng(po.load_stage + 17)
    idx = rng.choice(flat.shape[0], size=min(n_draws, flat.shape[0]),
                     replace=False)
    return [problem.ordering.to_point(q) for q in flat[idx]]


def plot_waveform_fits(problem, po: PlotOptions | None = None, point=None,
                       n_ensemble: int = 25):
    """
    Per-station waveform-fit pages (reference ``seismic_fits``
    ``beat/plotting/seismic.py``): observed (black) vs MAP synthetic
    (red) with the posterior-ensemble envelope (grey band, ``nensemble``
    analogue), per-trace variance reduction, epicentral distance/azimuth
    annotations and amplitude scale; spectrum-domain wavemaps plot
    amplitude spectra.  One figure per wavemap; returns the last path.
    """
    import matplotlib.pyplot as plt

    po = po or PlotOptions()
    comp = problem.composites.get("seismic")
    if comp is None:
        raise ValueError("Problem has no seismic composite")
    if point is None:
        point = _map_point(problem, po)

    synths = comp.get_synthetics(point)
    ens_points = _posterior_draws(problem, po, n_ensemble) if n_ensemble else []
    ens_synths = [comp.get_synthetics(p) for p in ens_points]

    wavemaps = getattr(comp, "wavemaps", None) or [w for w, _ in comp.wavemaps_libs]
    path = None
    for wmap in wavemaps:
        syn = np.asarray(synths[wmap.mapid])
        obs = np.asarray(wmap.data_windows)
        spectral = getattr(wmap, "domain", "time") == "spectrum"
        if spectral:
            # fit space: amplitude spectra of the windows (what the
            # likelihood compares), on the true rfft frequency grid
            syn = wmap.fit_transform_np(syn)
            obs = wmap.data_fit
        if ens_synths:
            ens = np.stack([
                wmap.fit_transform_np(np.asarray(s[wmap.mapid]))
                if spectral else np.asarray(s[wmap.mapid])
                for s in ens_synths])
            lo_env, hi_env = ens.min(axis=0), ens.max(axis=0)
        nt = wmap.ntargets
        ncols = 2
        nrows = (nt + ncols - 1) // ncols
        fig, axes = plt.subplots(nrows, ncols, figsize=(10, 1.8 * nrows),
                                 squeeze=False)
        if spectral:
            t = np.fft.rfftfreq(wmap.nsamples_win, wmap.table.dt)
            xlabel = "frequency [Hz]"
        else:
            t = np.arange(wmap.nsamples_win) * wmap.table.dt + wmap.taper.a
            xlabel = "time since arrival taper [s]"
        dists = np.hypot(np.asarray(wmap.station_east),
                         np.asarray(wmap.station_north))
        azis = np.rad2deg(np.arctan2(np.asarray(wmap.station_east),
                                     np.asarray(wmap.station_north))) % 360
        # per-station time shifts (station-correction hierarchicals) —
        # the reference colors each trace panel by its time shift
        shift_names = (wmap.time_shift_names()
                       if hasattr(wmap, "time_shift_names") else [])
        shifts = None
        if shift_names and all(n in point for n in shift_names):
            shifts = np.array([float(np.asarray(point[n]).ravel()[0])
                               for n in shift_names])
            smax = max(np.abs(shifts).max(), 1e-3)
            cmap = plt.get_cmap("coolwarm")

        # filtered-but-untapered context (reference plots the light-grey
        # filtered data around the fit window)
        ctx = None
        if not spectral and hasattr(wmap, "window_starts"):
            resp = wmap.filter_response_obs
            rows = []
            for ds, start in zip(wmap.datasets, wmap.window_starts):
                full = np.fft.irfft(np.fft.rfft(ds.ydata, n=wmap.table.nt)
                                    * resp, n=wmap.table.nt)
                rows.append(full[start:start + wmap.nsamples_win])
            ctx = np.stack(rows)

        vrs = []
        for i in range(nt):
            ax = axes[i // ncols][i % ncols]
            if ctx is not None:
                ax.plot(t, ctx[i], color="0.75", lw=0.6,
                        label="filtered" if i == 0 else None)
            if ens_synths:
                ax.fill_between(t, lo_env[i], hi_env[i], color="grey",
                                alpha=0.35, lw=0, label="posterior")
            ax.plot(t, obs[i], "k", lw=0.8, label="data")
            ax.plot(t, syn[i], "r", lw=0.8, label="MAP")
            ds = wmap.datasets[i]
            vr = max(1.0 - ((obs[i] - syn[i]) ** 2).sum() / max(
                (obs[i] ** 2).sum(), 1e-30), -9.99)
            vrs.append(vr)
            # residual trace, offset below (reference's red residual row)
            span = max(np.abs(obs[i]).max(), np.abs(syn[i]).max(), 1e-30)
            ax.plot(t, (obs[i] - syn[i]) - 1.6 * span, color="darkred",
                    lw=0.5, label="residual" if i == 0 else None)
            sta_color = "k"
            if shifts is not None:
                sta_color = cmap(0.5 + 0.5 * shifts[i] / smax)
                ax.text(0.98, 0.04, f"Δt {shifts[i]:+.2f}s", fontsize=6,
                        ha="right", transform=ax.transAxes, color=sta_color)
            ax.text(0.02, 0.82, f"{ds.station}.{ds.channel}", fontsize=7,
                    transform=ax.transAxes, weight="bold", color=sta_color)
            ax.text(0.02, 0.04,
                    f"{dists[i] / 1e3:.0f} km  {azis[i]:.0f}°  "
                    f"VR {100 * vr:.0f}%",
                    fontsize=6, transform=ax.transAxes)
            ax.text(0.76, 0.82, f"|max| {np.abs(obs[i]).max():.2e}",
                    fontsize=6, ha="right", transform=ax.transAxes)
            if not spectral:
                # taper flanks (reference plots the arrival taper)
                for x in (wmap.taper.b, wmap.taper.c):
                    ax.axvline(x, color="#2c7fb8", lw=0.5, ls=":")
                # amplitude-spectrum inset over the fit band (reference
                # spectra insets): obs vs MAP in log amplitude
                ia = ax.inset_axes([0.78, 0.55, 0.2, 0.4])
                freqs = np.fft.rfftfreq(wmap.nsamples_win, wmap.table.dt)
                band = (freqs > 0)
                lo_c = getattr(wmap.filterer, "lower_corner", None)
                hi_c = getattr(wmap.filterer, "upper_corner", None)
                if lo_c and hi_c:
                    band &= (freqs >= 0.5 * lo_c) & (freqs <= 2.0 * hi_c)
                ia.loglog(freqs[band],
                          np.abs(np.fft.rfft(obs[i]))[band] + 1e-30,
                          "k", lw=0.5)
                ia.loglog(freqs[band],
                          np.abs(np.fft.rfft(syn[i]))[band] + 1e-30,
                          "r", lw=0.5)
                ia.set_xticks([])
                ia.set_yticks([])
                for s in ia.spines.values():
                    s.set_linewidth(0.3)
            format_axes(ax)
            ax.set_yticks([])
            if i // ncols == nrows - 1:
                ax.set_xlabel(xlabel, fontsize=7)
            ax.tick_params(labelsize=6)
        axes[0][0].legend(fontsize=6, loc="upper left", ncol=2)
        for j in range(nt, nrows * ncols):
            axes[j // ncols][j % ncols].axis("off")
        fig.suptitle(f"waveform fits — {wmap.mapid}"
                     + (" (spectra)" if spectral else ""), fontsize=10)
        fig.tight_layout()
        path = save_figure(fig, problem.outfolder,
                           f"waveform_fits_{wmap.mapid}", po)

        # misfit-CDF page (reference's CDF diagnostic): empirical CDFs
        # of per-trace VR and normalized L2 misfit
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(8, 3))
        vrs_arr = np.sort(np.asarray(vrs))
        mis = np.sort(np.sqrt(((obs - syn) ** 2).sum(axis=1)
                              / np.maximum((obs ** 2).sum(axis=1), 1e-30)))
        q = np.arange(1, nt + 1) / nt
        ax1.step(vrs_arr, q, where="post", color="#2c7fb8")
        ax1.set_xlabel("variance reduction")
        ax1.set_ylabel("CDF")
        ax2.step(mis, q, where="post", color="#cb4b16")
        ax2.set_xlabel("normalized misfit ‖r‖/‖d‖")
        for ax in (ax1, ax2):
            ax.set_ylim(0, 1)
            format_axes(ax)
        fig.suptitle(f"misfit CDFs — {wmap.mapid}", fontsize=10)
        fig.tight_layout()
        save_figure(fig, problem.outfolder,
                    f"waveform_fits_{wmap.mapid}_cdf", po)
    return path


def plot_station_variance_reductions(problem, po: PlotOptions | None = None, point=None):
    """Bar chart of per-station variance reductions
    (reference ``station_variance_reductions``)."""
    import matplotlib.pyplot as plt

    po = po or PlotOptions()
    comp = problem.composites.get("seismic")
    if point is None:
        point = _map_point(problem, po)
    synths = comp.get_synthetics(point)
    wavemaps = getattr(comp, "wavemaps", None) or [w for w, _ in comp.wavemaps_libs]
    fig, axes = plt.subplots(len(wavemaps), 1,
                             figsize=(8, 2.5 * len(wavemaps)), squeeze=False)
    for k, wmap in enumerate(wavemaps):
        syn = synths[wmap.mapid]
        obs = wmap.data_windows
        vrs = 1.0 - ((obs - syn) ** 2).sum(axis=1) / np.maximum(
            (obs**2).sum(axis=1), 1e-30)
        ax = axes[k][0]
        ax.bar(range(len(vrs)), vrs, color="#2c7fb8")
        ax.set_xticks(range(len(vrs)))
        ax.set_xticklabels([ds.station for ds in wmap.datasets],
                           rotation=60, fontsize=7)
        ax.set_ylabel("VR")
        ax.set_title(wmap.mapid, fontsize=9)
        format_axes(ax)
    fig.tight_layout()
    return save_figure(fig, problem.outfolder, "station_variance_reductions", po)


def plot_velocity_models(problem=None, po: PlotOptions | None = None,
                         models=None):
    """Step profiles of vp/vs/rho vs depth for the project's layered
    model(s) (reference ``velocity_models`` plot,
    ``beat/plotting/seismic.py``).  ``models``: explicit list of
    :class:`~beat_tpu_torch.heart.velocity_model.LayeredModel`; default: the
    project model next to the problem's outfolder plus homogeneous
    models implied by any GF tables."""
    import os

    import matplotlib.pyplot as plt

    from beat_tpu_torch.heart.velocity_model import LayeredModel

    if models is None:
        models = []
        if problem is not None:
            from beat_tpu_torch.config import load_velocity_model

            project_dir = os.path.dirname(problem.outfolder.rstrip("/"))
            models.append(load_velocity_model(project_dir))
            for comp in problem.composites.values():
                for wmap in getattr(comp, "wavemaps", []):
                    t = wmap.table
                    models.append(LayeredModel.homogeneous(
                        vp=t.vp, vs=t.vs, rho=getattr(t, "rho", 2700.0)))
        if not models:
            models = [LayeredModel.default_crust()]

    fig, axs = plt.subplots(1, 3, figsize=(9, 5), sharey=True)
    zmax = max(float(m.tops[-1]) for m in models) * 1.3 + 5e3
    for m in models:
        z_edges = np.concatenate([m.tops, [zmax]])
        for ax, vals, label in zip(
                axs, (m.vp, m.vs, m.rho), ("vp [m/s]", "vs [m/s]", "rho [kg/m³]")):
            ax.step(np.repeat(vals, 2),
                    np.repeat(z_edges, 2)[1:-1] / 1e3, where="post",
                    label=m.name)
            ax.set_xlabel(label)
            format_axes(ax)
    axs[0].set_ylabel("depth [km]")
    axs[0].invert_yaxis()
    axs[0].legend(fontsize=7)
    fig.suptitle("velocity models")
    outfolder = problem.outfolder if problem is not None else "."
    return save_figure(fig, outfolder, "velocity_models", po)
