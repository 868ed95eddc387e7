"""Geodetic fit plots (copied from ``beat_tpu/plotting/geodetic.py``;
reference ``beat/plotting/geodetic.py``)."""

from __future__ import annotations

import numpy as np

from beat_tpu_torch.plotting.common import PlotOptions, save_figure


def plot_scene_fits(problem, po: PlotOptions | None = None, point=None):
    """
    Data / synthetic / residual triptych per geodetic dataset at the MAP
    (or given) point — matplotlib analogue of the reference's kite-based
    ``scene_fits``; GNSS datasets get quiver-style scatter.
    """
    import matplotlib.pyplot as plt

    from beat_tpu_torch.backend import SampleStage

    po = po or PlotOptions()
    comp = problem.composites.get("geodetic")
    if comp is None:
        raise ValueError("Problem has no geodetic composite")

    if point is None:
        handler = SampleStage(problem.outfolder, ordering=problem.ordering)
        trace = handler.load_trace(po.load_stage)
        pop, llks = trace.end_points()
        point = problem.ordering.to_point(pop[int(np.argmax(llks))])

    synths = comp.get_synthetics(point)
    vrs = comp.get_variance_reductions(point) \
        if hasattr(comp, "get_variance_reductions") else {}
    n_ds = len(comp.datasets)
    fig, axes = plt.subplots(n_ds, 3, figsize=(12, 3.4 * n_ds), squeeze=False)
    # the model panel includes the sampled correction displacements
    # (ramps / plate motions) so the residual is the one the likelihood sees
    corrections = (comp._corrections_np(point) if hasattr(comp, "_corrections_np")
                   else [0.0] * n_ds)
    for i, (ds, corr) in enumerate(zip(comp.datasets, corrections)):
        obs = ds.displacement
        syn = np.asarray(synths[ds.name]) + corr
        res = obs - syn
        vmax = np.abs(obs).max()
        for j, (vals, title) in enumerate(
                ((obs, "data"), (syn, "model + corrections"),
                 (res, "residual"))):
            ax = axes[i][j]
            sc = ax.scatter(ds.coords[:, 0] / 1e3, ds.coords[:, 1] / 1e3,
                            c=vals, s=14, cmap="RdBu_r", vmin=-vmax, vmax=vmax)
            ax.set_title(f"{ds.name} {title}", fontsize=9)
            ax.set_aspect("equal")
            if j == 2:
                fig.colorbar(sc, ax=ax, shrink=0.8, label="LOS disp [m]")
                if ds.name in vrs:
                    ax.text(0.02, 0.02, f"VR {100 * vrs[ds.name]:.0f}%",
                            fontsize=8, transform=ax.transAxes)
        event = getattr(problem, "event", None)
        if event is not None and (event.lat, event.lon) != (0.0, 0.0):
            from beat_tpu_torch.plotting.common import add_geographic_context

            add_geographic_context(axes[i][0], event)
    fig.tight_layout()
    return save_figure(fig, problem.outfolder, "scene_fits", po)


def plot_gnss_fits(problem, po: PlotOptions | None = None, point=None):
    """
    GNSS horizontal-vector fits: observed vs synthetic arrows per station
    (reference ``gnss_fits``).  Uses the east/north component datasets of
    the geodetic composite.
    """
    import matplotlib.pyplot as plt

    from beat_tpu_torch.backend import SampleStage

    po = po or PlotOptions()
    comp = problem.composites.get("geodetic")
    if comp is None:
        raise ValueError("Problem has no geodetic composite")
    gnss = {ds.name: ds for ds in comp.datasets if ds.typ == "GNSS"}
    if not gnss:
        raise ValueError("No GNSS datasets in the problem")

    if point is None:
        handler = SampleStage(problem.outfolder, ordering=problem.ordering)
        trace = handler.load_trace(po.load_stage)
        pop, llks = trace.end_points()
        point = problem.ordering.to_point(pop[int(np.argmax(llks))])
    synths = comp.get_synthetics(point)

    east = next((d for n, d in gnss.items() if "east" in n.lower()), None)
    north = next((d for n, d in gnss.items() if "north" in n.lower()), None)
    fig, ax = plt.subplots(figsize=(7, 7))
    if east is not None and north is not None:
        coords = east.coords / 1e3
        ax.quiver(coords[:, 0], coords[:, 1],
                  east.displacement, north.displacement,
                  color="k", label="observed", scale_units="xy")
        ax.quiver(coords[:, 0], coords[:, 1],
                  synths[east.name], synths[north.name],
                  color="crimson", label="synthetic", scale_units="xy")
    else:  # single-component fallback: scatter fits
        for name, ds in gnss.items():
            ax.scatter(ds.coords[:, 0] / 1e3, ds.displacement, s=12,
                       label=f"{name} obs")
            ax.scatter(ds.coords[:, 0] / 1e3, synths[name], s=12, marker="x",
                       label=f"{name} synth")
    ax.set_xlabel("east [km]")
    ax.set_ylabel("north [km]")
    ax.legend(fontsize=8)
    ax.set_aspect("equal")
    return save_figure(fig, problem.outfolder, "gnss_fits", po)


def plot_geodetic_covariances(problem, po: PlotOptions | None = None):
    """Per-dataset data-covariance matrices (reference
    ``geodetic_covariances``)."""
    import matplotlib.pyplot as plt

    po = po or PlotOptions()
    comp = problem.composites.get("geodetic")
    if comp is None:
        raise ValueError("Problem has no geodetic composite")
    n = len(comp.datasets)
    fig, axes = plt.subplots(1, n, figsize=(4.5 * n, 4), squeeze=False)
    for i, ds in enumerate(comp.datasets):
        ax = axes[0][i]
        im = ax.matshow(ds.covariance.p_total, cmap="viridis")
        ax.set_title(ds.name, fontsize=9)
        fig.colorbar(im, ax=ax, shrink=0.8)
    fig.tight_layout()
    return save_figure(fig, problem.outfolder, "geodetic_covariances", po)


def plot_station_map(problem, po: PlotOptions | None = None):
    """
    Station/data geometry overview (matplotlib replacement of the
    GMT-based reference ``station_map``): seismic stations, geodetic
    data footprints and source locations in local coordinates.
    """
    import matplotlib.pyplot as plt

    po = po or PlotOptions()
    fig, ax = plt.subplots(figsize=(7, 7))
    geo = problem.composites.get("geodetic")
    if geo is not None:
        for ds in geo.datasets:
            ax.scatter(ds.coords[:, 0] / 1e3, ds.coords[:, 1] / 1e3, s=4,
                       alpha=0.3, label=ds.name)
    seis = problem.composites.get("seismic")
    if seis is not None and hasattr(seis, "wavemaps"):
        for wmap in seis.wavemaps:
            ax.scatter(wmap.station_east / 1e3, wmap.station_north / 1e3,
                       marker="^", s=60, color="k", zorder=3)
            for ds, e, n in zip(wmap.datasets, wmap.station_east, wmap.station_north):
                ax.annotate(ds.station, (e / 1e3, n / 1e3), fontsize=6,
                            xytext=(2, 2), textcoords="offset points")
        sources = getattr(seis, "sources", None) or []
    else:
        sources = getattr(geo, "sources", None) or [] if geo else []
    for src in sources:
        ax.scatter([src.east_shift / 1e3], [src.north_shift / 1e3],
                   marker="*", s=200, color="gold", edgecolor="k", zorder=4)
    # epicentral distance rings (GMT-map analogue)
    if seis is not None and hasattr(seis, "wavemaps"):
        dmax = max((float(np.hypot(wmap.station_east,
                                   wmap.station_north).max())
                    for wmap in seis.wavemaps), default=0.0) / 1e3
        if dmax > 0:
            step = max(np.round(dmax / 3 / 10) * 10, 10)
            for rkm in np.arange(step, dmax + step, step):
                ring = plt.Circle((0, 0), rkm, fill=False, color="grey",
                                  lw=0.5, ls="--", zorder=1)
                ax.add_patch(ring)
                ax.annotate(f"{rkm:.0f} km", (0, rkm), fontsize=6,
                            color="grey", ha="center")
    # focal-mechanism inset for MT-family sources
    m6s = []
    for src in sources:
        m6 = getattr(src, "m6", None)
        if callable(m6):
            try:
                arr = np.asarray(m6())
                if np.abs(arr).max() > 0:
                    m6s.append(arr)
            except Exception:
                pass
    if m6s:
        from beat_tpu_torch.plotting.mt import beachball_image

        inset = ax.inset_axes([0.01, 0.01, 0.22, 0.22])
        inset.imshow(beachball_image(m6s, grid_n=101),
                     extent=[-1, 1, -1, 1], origin="lower",
                     cmap="RdGy_r", vmin=-1, vmax=1)
        inset.add_patch(plt.Circle((0, 0), 1.0, fill=False, color="k",
                                   lw=0.8))
        inset.set_aspect("equal")
        inset.axis("off")
    ax.set_xlabel("east [km]")
    ax.set_ylabel("north [km]")
    ax.set_aspect("equal")
    event = getattr(problem, "event", None)
    if event is not None and (event.lat, event.lon) != (0.0, 0.0):
        from beat_tpu_torch.plotting.common import add_geographic_context

        add_geographic_context(ax, event)
    if geo is not None:
        ax.legend(fontsize=7, loc="upper right")
    return save_figure(fig, problem.outfolder, "station_map", po)
