"""FFI plots: slip distribution and moment rate (copied from
``beat_tpu/plotting/ffi.py``; reference ``beat/plotting/ffi.py``).  Rupture
onsets come from the fault's batched eikonal solve and the moment rate
from :func:`beat_tpu_torch.sources.half_sinusoid_stf`, on the problem's
device.  The nucleation star of :func:`plot_fault_geometry` is placed at
the sampled nucleation point in metres; the JAX package's copy scales it
by 1e3 more."""

from __future__ import annotations

import numpy as np

from beat_tpu_torch.plotting.common import PlotOptions, format_axes, save_figure


def _draw_patch_field(ax, fig, sf, values, cmap, label, vmax=None):
    """One per-patch scalar field on a subfault (regular grid via imshow,
    irregular resolution-discretized geometry via patch rectangles)."""
    if not hasattr(sf, "n_strike"):
        from matplotlib.collections import PatchCollection
        from matplotlib.patches import Rectangle

        centers = sf.patch_centers_local() / 1e3
        rects = [Rectangle((c[0] - p.length / 2e3, c[1] - p.width / 2e3),
                           p.length / 1e3, p.width / 1e3)
                 for c, p in zip(centers, sf.patches)]
        pc = PatchCollection(rects, cmap=cmap, edgecolor="k", linewidth=0.3)
        pc.set_array(values)
        if vmax is not None:
            pc.set_clim(0.0, vmax)
        im = ax.add_collection(pc)
        ax.set_xlim(0, sf.plane.length / 1e3)
        ax.set_ylim(sf.plane.width / 1e3, 0)
    else:
        grid = values.reshape(sf.n_dip, sf.n_strike)
        im = ax.imshow(grid, cmap=cmap, aspect="auto", vmin=0.0, vmax=vmax,
                       extent=[0, sf.plane.length / 1e3,
                               sf.plane.width / 1e3, 0])
    fig.colorbar(im, ax=ax, label=label)
    ax.set_xlabel("along strike [km]")
    ax.set_ylabel("down dip [km]")
    return im


def _patch_corners(p) -> np.ndarray:
    """(4, 3) corners of a RectangularSource in (east, north, depth) [m],
    walked top-left → top-right → bottom-right → bottom-left (reference
    ``outline()`` convention, ``beat/plotting/ffi.py:210-232``)."""
    frac = {"top": 0.0, "center": 0.5, "bottom": 1.0}.get(p.anchor, 0.0)
    sv, dv = p.strikevector, p.dipvector          # ENU, z up-positive
    s3 = np.array([sv[0], sv[1], 0.0])
    d3 = np.array([dv[0], dv[1], -dv[2]])         # (E, N, depth-down)
    anchor = np.array([p.east_shift, p.north_shift, p.depth])
    tl = anchor - d3 * (p.width * frac) - s3 * (p.length / 2.0)
    return np.stack([tl, tl + s3 * p.length,
                     tl + s3 * p.length + d3 * p.width, tl + d3 * p.width])


def plot_fault_geometry(problem, po: PlotOptions | None = None, point=None,
                        fault=None):
    """
    3-D rotatable source-geometry view (reference ``source_geometry``
    ``beat/plotting/ffi.py:184-338``): every subfault patch as a 3-D
    face colored by its slip at ``point`` (posterior mean by default),
    bold top-edge + outline per subfault plane, nucleation star for
    kinematic points, and dataset positions at the free surface.
    """
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.plotting.colormap import slip_colormap

    po = po or PlotOptions()
    if fault is None:
        for comp in problem.composites.values():
            if hasattr(comp, "fault"):
                fault = comp.fault
                break
    if fault is None:
        raise ValueError("No fault geometry in problem composites")

    if point is None:
        try:
            handler = SampleStage(problem.outfolder, ordering=problem.ordering)
            trace = handler.load_trace(po.load_stage)
            flat = trace.q_trace.reshape(-1, trace.q_trace.shape[-1])
            point = problem.ordering.to_point(flat.mean(axis=0))
        except Exception:
            point = {}
    uparr = np.asarray(point.get("uparr", np.zeros(fault.npatches)))
    uperp = np.asarray(point.get("uperp", np.zeros(fault.npatches)))
    slip = np.sqrt(np.atleast_1d(uparr) ** 2 + np.atleast_1d(uperp) ** 2)
    if slip.size != fault.npatches:
        slip = np.zeros(fault.npatches)

    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    cmap = slip_colormap()
    vmax = max(float(slip.max()), 1e-9)
    k = 0
    for i in range(fault.nsubfaults):
        sf = fault.get_subfault(i)
        faces, colors = [], []
        for p in sf.patches:
            c = _patch_corners(p) / 1e3
            faces.append([(x, y, -z) for x, y, z in c])  # z up, [km]
            colors.append(cmap(slip[k] / vmax))
            k += 1
        pc = Poly3DCollection(faces, facecolors=colors, edgecolor="k",
                              linewidths=0.2, alpha=0.7)
        ax.add_collection3d(pc)
        # bold plane outline, top edge solid black (reference marks the
        # updip edge so dip direction is readable)
        o = _patch_corners(sf.plane) / 1e3
        ax.plot(np.r_[o[:, 0], o[0, 0]], np.r_[o[:, 1], o[0, 1]],
                -np.r_[o[:, 2], o[0, 2]], color="k", lw=1.5)
        ax.plot(o[:2, 0], o[:2, 1], -o[:2, 2], color="k", lw=3.0)
        if "nucleation_strike" in point and hasattr(sf, "n_strike"):
            pos = nucleation_position(sf, point, i) / 1e3
            ax.scatter([pos[0]], [pos[1]], [-pos[2]], marker="*", s=140,
                       color="gold", edgecolor="k", zorder=5)
    for comp in problem.composites.values():
        for ds in getattr(comp, "datasets", []):
            if hasattr(ds, "coords"):
                xy = np.asarray(ds.coords)[:, :2] / 1e3
                ax.scatter(xy[:, 0], xy[:, 1], np.zeros(len(xy)), s=3,
                           color="0.5", alpha=0.4, depthshade=False)
            elif hasattr(ds, "east"):
                ax.scatter([ds.east / 1e3], [ds.north / 1e3], [0.0],
                           marker="^", s=40, color="tab:blue",
                           edgecolor="k", depthshade=False)
    import matplotlib.cm as mcm

    sm = mcm.ScalarMappable(cmap=cmap)
    sm.set_clim(0.0, vmax)
    fig.colorbar(sm, ax=ax, shrink=0.55, label="slip [m]")
    ax.set_xlabel("east [km]")
    ax.set_ylabel("north [km]")
    ax.set_zlabel("depth [km]")
    return save_figure(fig, problem.outfolder, "fault_geometry", po)


def nucleation_position(sf, point: dict, i: int) -> np.ndarray:
    """(east, north, depth) [m] of subfault ``i``'s sampled nucleation
    point (``nucleation_strike``/``nucleation_dip`` [m] from the plane's
    top-left corner); a scalar nucleation serves every subfault."""
    ns = np.atleast_1d(np.asarray(point["nucleation_strike"], dtype=float))
    nd = np.atleast_1d(np.asarray(point["nucleation_dip"], dtype=float))
    sv, dv = sf.plane.strikevector, sf.plane.dipvector
    tl = _patch_corners(sf.plane)[0]
    return (tl + np.array([sv[0], sv[1], 0.0]) * ns[min(i, ns.size - 1)]
            + np.array([dv[0], dv[1], -dv[2]]) * nd[min(i, nd.size - 1)])


def _starttimes(fault, i, velocities, nuc_strike: float, nuc_dip: float, device):
    """(npatches,) rupture-onset times of subfault ``i`` of one point."""
    import torch

    return fault.point2starttimes(
        i, torch.as_tensor(np.asarray(velocities, dtype=np.float32)[None], device=device),
        torch.tensor([nuc_strike], dtype=torch.float32, device=device),
        torch.tensor([nuc_dip], dtype=torch.float32, device=device))[0].double().cpu().numpy()


def _starttime_grid(fault, i, sf, point, slc, device):
    """Rupture-onset times of one (regular-grid) subfault at one point."""
    return _starttimes(fault, i, np.asarray(point["velocities"])[slc],
                       float(np.atleast_1d(point["nucleation_strike"])[i]),
                       float(np.atleast_1d(point["nucleation_dip"])[i]),
                       device).reshape(sf.n_dip, sf.n_strike)


def plot_slip_distribution(problem, po: PlotOptions | None = None, point=None,
                           fault=None, n_fuzzy: int = 30):
    """
    The FFI money plot (reference ``slip_distribution``
    ``beat/plotting/ffi.py``): per subfault a posterior-MEAN slip panel
    (slip-direction quivers, posterior-mean rupture-front isochrones,
    FUZZY fronts from ``n_fuzzy`` posterior draws, nucleation-point
    marker + its posterior scatter) next to a posterior-UNCERTAINTY
    panel (per-patch slip standard deviation over the stage trace).
    """
    import matplotlib.pyplot as plt

    from beat_tpu_torch.backend import SampleStage

    po = po or PlotOptions()
    if fault is None:
        for comp in problem.composites.values():
            if hasattr(comp, "fault"):
                fault = comp.fault
                break
    if fault is None:
        raise ValueError("No fault geometry in problem composites")

    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    trace = handler.load_trace(po.load_stage)
    flat = trace.q_trace.reshape(-1, trace.q_trace.shape[-1])
    mean_point = problem.ordering.to_point(flat.mean(axis=0))
    if point is not None:
        mean_point.update(point)

    npatch = fault.npatches
    uparr = np.asarray(mean_point.get("uparr", np.zeros(npatch)))
    uperp = np.asarray(mean_point.get("uperp", np.zeros(npatch)))
    slip = np.sqrt(uparr**2 + uperp**2)

    # per-patch slip std over the posterior (uncertainty panel)
    slip_std = None
    ordering = problem.ordering
    if "uparr" in ordering:
        sl_a = ordering["uparr"].slc
        s_a = flat[:, sl_a]
        s_p = flat[:, ordering["uperp"].slc] if "uperp" in ordering else 0.0
        slip_std = np.std(np.sqrt(np.square(s_a) + np.square(s_p)),
                          axis=0, ddof=1)

    kinematic = "velocities" in mean_point \
        and "nucleation_strike" in mean_point
    # posterior draws for fuzzy rupture fronts / nucleation scatter
    draw_points = []
    if kinematic and flat.shape[0] > 1:
        idx = np.linspace(0, flat.shape[0] - 1,
                          min(n_fuzzy, flat.shape[0])).astype(int)
        draw_points = [problem.ordering.to_point(flat[k]) for k in idx]

    n_sf = fault.nsubfaults
    ncols = 2 if slip_std is not None else 1
    fig, axes = plt.subplots(n_sf, ncols,
                             figsize=(7.5 * ncols, 4 * n_sf), squeeze=False)
    from beat_tpu_torch.plotting.colormap import slip_colormap

    for i in range(n_sf):
        sf = fault.get_subfault(i)
        slc = fault.ordering.slices[i]
        ax = axes[i][0]
        _draw_patch_field(ax, fig, sf, slip[slc], slip_colormap(),
                          "mean slip [m]")
        if hasattr(sf, "n_strike"):
            # slip-direction arrows (along-strike uparr, up-dip uperp —
            # the reference draws per-patch slip vectors)
            if np.any(uperp[slc]) and np.any(uparr[slc]):
                s = (np.arange(sf.n_strike) + 0.5) * sf.patch_length / 1e3
                d = (np.arange(sf.n_dip) + 0.5) * sf.patch_width / 1e3
                ss, dd = np.meshgrid(s, d)
                ax.quiver(ss, dd, uparr[slc].reshape(sf.n_dip, sf.n_strike),
                          -uperp[slc].reshape(sf.n_dip, sf.n_strike),
                          color="w", width=0.003, scale_units="width",
                          scale=max(np.abs(slip[slc]).max() * 25, 1e-9))
            if kinematic:
                s = (np.arange(sf.n_strike) + 0.5) * sf.patch_length / 1e3
                d = (np.arange(sf.n_dip) + 0.5) * sf.patch_width / 1e3
                # fuzzy fronts: isochrones of posterior draws (reference
                # ``fuzzy_rupture_fronts``, beat/plotting/ffi.py)
                for pt in draw_points:
                    times_k = _starttime_grid(fault, i, sf, pt, slc, problem.device)
                    ax.contour(s, d, times_k, colors="w", linewidths=0.4,
                               alpha=0.25)
                times = _starttime_grid(fault, i, sf, mean_point, slc, problem.device)
                cs = ax.contour(s, d, times, colors="k", linewidths=0.8)
                ax.clabel(cs, fontsize=6, fmt="%.1f s")
                # nucleation: posterior scatter + mean marker (reference
                # draws the hypocenter star)
                nuc_s = [float(np.atleast_1d(pt["nucleation_strike"])[i]) / 1e3
                         for pt in draw_points]
                nuc_d = [float(np.atleast_1d(pt["nucleation_dip"])[i]) / 1e3
                         for pt in draw_points]
                ax.plot(nuc_s, nuc_d, ".", color="w", ms=2, alpha=0.5)
                ax.plot(
                    float(np.atleast_1d(mean_point["nucleation_strike"])[i]) / 1e3,
                    float(np.atleast_1d(mean_point["nucleation_dip"])[i]) / 1e3,
                    marker="*", ms=14, mfc="gold", mec="k", mew=0.8, ls="")
        if slip_std is not None:
            _draw_patch_field(axes[i][1], fig, sf, slip_std[slc],
                              "magma", "slip std [m]")
            axes[i][1].set_title("posterior uncertainty", fontsize=9)
            ax.set_title("posterior mean", fontsize=9)
    fig.tight_layout()
    return save_figure(fig, problem.outfolder, "slip_distribution", po)


def moment_rates(problem, fault, draws, t, shear_modulus=33e9) -> np.ndarray:
    """(n, T) moment-rate functions [Nm/s] of the flat posterior draws
    ``draws`` (n, dim) at the times ``t`` (T,) after origin: Σ over
    patches of µ·A·|uparr| times the half-sinusoid STF of the patch's
    duration, delayed by its rupture onset (the fault's eikonal solve, all
    draws as one batch a subfault; 0 without ``velocities``).  On the
    problem's device, float64 but for the onsets."""
    import torch

    from beat_tpu_torch.sources import half_sinusoid_stf

    dev = problem.device
    n = len(draws)
    point = problem.ordering.to_point(torch.as_tensor(np.asarray(draws), dtype=torch.float64))

    def per_patch(name, default):
        v = point[name] if name in point else torch.full((n, 1), float(default),
                                                          dtype=torch.float64)
        return v.reshape(n, -1).expand(n, fault.npatches).to(dev)

    uparr, durations = per_patch("uparr", 0.0), per_patch("durations", 1.0)
    onsets = torch.zeros((n, fault.npatches), dtype=torch.float64, device=dev)
    if "velocities" in point:
        # per-subfault slices: velocities/nucleation are vector-valued on
        # multi-subfault faults (hypo_vars per subfault)
        def nucleation(name, i):
            v = point.get(name, torch.zeros(n, dtype=torch.float64)).reshape(n, -1)
            return v[:, min(i, v.shape[1] - 1)].float().to(dev)

        for i in range(fault.nsubfaults):
            vel = fault.ordering.vector2subfault(i, point["velocities"]).float().to(dev)
            onsets[:, fault.ordering.slices[i]] = fault.point2starttimes(
                i, vel, nucleation("nucleation_strike", i),
                nucleation("nucleation_dip", i)).double()
    areas = torch.as_tensor(fault.patch_areas(), dtype=torch.float64, device=dev)
    tt = torch.as_tensor(np.asarray(t), dtype=torch.float64, device=dev)
    stf = half_sinusoid_stf(tt - onsets[..., None], durations[..., None])   # (n, P, T)
    m0 = shear_modulus * areas * uparr.abs()
    return (m0[..., None] * stf).sum(1).cpu().numpy()


def plot_moment_rate(problem, po: PlotOptions | None = None, fault=None,
                     shear_modulus=33e9, n_samples: int = 100):
    """
    Posterior ensemble of moment-rate functions from slip + durations +
    rupture onsets (reference ``moment_rate``).
    """
    import matplotlib.pyplot as plt

    from beat_tpu_torch.backend import SampleStage

    po = po or PlotOptions()
    if fault is None:
        for comp in problem.composites.values():
            if hasattr(comp, "fault"):
                fault = comp.fault
                break
    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    trace = handler.load_trace(po.load_stage)
    flat = trace.q_trace.reshape(-1, trace.q_trace.shape[-1])
    idx = np.linspace(0, flat.shape[0] - 1, min(n_samples, flat.shape[0])).astype(int)

    t = np.linspace(0, 30, 300)
    fig, ax = plt.subplots(figsize=(7, 4))
    rates = moment_rates(problem, fault, flat[idx], t, shear_modulus)
    # fuzzy posterior density (reference ``fuzzy_moment_rate``
    # ``beat/plotting/ffi.py:41-84``): bin every draw's curve into a
    # (t, rate) histogram and shade by coverage, mean curve on top
    rmax = max(float(rates.max()) * 1.05, 1e-30)
    ngrid = 250
    H = np.zeros((ngrid, ngrid))
    edges_t = np.linspace(t[0], t[-1], ngrid + 1)
    edges_r = np.linspace(0.0, rmax, ngrid + 1)
    for r in rates:
        H += np.histogram2d(t, r, bins=[edges_t, edges_r])[0]
    ax.imshow(np.log1p(H.T), origin="lower", aspect="auto", cmap="Greys",
              extent=(t[0], t[-1], 0.0, rmax), interpolation="bilinear",
              vmin=0.0, vmax=max(float(np.log1p(H).max()) / 2.0, 1e-9))
    ax.plot(t, rates.mean(axis=0), color="k", lw=1.5, label="posterior mean")
    ax.legend(frameon=False, fontsize=8)
    ax.set_xlabel("time after origin [s]")
    ax.set_ylabel("moment rate [Nm/s]")
    format_axes(ax)
    return save_figure(fig, problem.outfolder, "moment_rate", po)
