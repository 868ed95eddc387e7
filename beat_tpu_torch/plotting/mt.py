"""Moment-tensor source-type plots: Hudson, lune, fuzzy beachball (copied
from ``beat_tpu/plotting/mt.py``; reference ``beat/plotting/marginals.py``
hudson/lune + ``fuzzy_beachball``).  The draws' moment tensors are
computed by the composite's ``source_m6`` on the problem's device, all
draws as one batch."""

from __future__ import annotations

import numpy as np

from beat_tpu_torch.mt_utils import hudson_coords, lune_coords, radiation_amplitude
from beat_tpu_torch.plotting.common import PlotOptions, format_axes, save_figure


def _posterior_m6s(problem, po, n_samples=500, source_idx: int = 0):
    """(n, 6) m6 tensors of source ``source_idx`` of ``n_samples`` draws
    spread over the posterior trace (multi-source problems carry
    vector-valued MT parameters), float64 on the host."""
    import torch

    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.models.seismic import point_getter, source_m6

    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    trace = handler.load_trace(po.load_stage)
    flat = trace.q_trace.reshape(-1, trace.q_trace.shape[-1])
    idx = np.linspace(0, flat.shape[0] - 1, min(n_samples, flat.shape[0])).astype(int)

    sources = None
    for comp in problem.composites.values():
        if getattr(comp, "sources", None):
            sources = comp.sources
            break
    if sources is None:
        raise ValueError("No source templates in problem")
    if not (0 <= source_idx < len(sources)):
        raise ValueError(f"source_idx {source_idx} outside "
                         f"[0, {len(sources)})")
    template = sources[source_idx]

    q = torch.as_tensor(flat[idx], dtype=torch.float32, device=problem.device)
    get = point_getter(template, problem.ordering.to_point(q), source_idx, len(sources),
                       q.shape[0], problem.device)
    with torch.no_grad():
        return source_m6(template, get).double().cpu().numpy()


def plot_hudson(problem, po: PlotOptions | None = None, n_samples=500,
                source_idx: int = 0):
    """Posterior cloud on the Hudson τ-k diamond (reference ``hudson``;
    unskewed variant: coordinates u = τ(1-|k|), v = k, whose reachable
    region IS the drawn diamond with corners (±1, 0), (0, ±1) —
    reference marks: DC at the origin, ±crack/±dipole along the edges)."""
    import matplotlib.pyplot as plt

    po = po or PlotOptions()
    m6s = _posterior_m6s(problem, po, n_samples, source_idx)
    uv = np.array([hudson_coords(m6) for m6 in m6s])

    fig, ax = plt.subplots(figsize=(5, 5))
    # τ-k diamond outline (the exact boundary of the coordinates used)
    ax.plot([0, 1, 0, -1, 0], [1, 0, -1, 0, 1], "k", lw=0.8)
    ax.plot([-1, 1], [0, 0], "k:", lw=0.5)
    ax.plot([0, 0], [-1, 1], "k:", lw=0.5)
    # canonical source-type marks
    for (u, v, label) in [(0, 1, "+ISO"), (0, -1, "-ISO"),
                          (1, 0, "CLVD"), (-1, 0, "CLVD")]:
        ax.annotate(label, (u, v), fontsize=6, ha="center",
                    xytext=(u * 1.08, v * 1.08))
    ax.scatter(uv[:, 0], uv[:, 1], s=6, alpha=0.3, color="#2c7fb8")
    ax.set_xlabel("u = τ(1-|k|) (CLVD)")
    ax.set_ylabel("v = k (ISO)")
    ax.set_xlim(-1.2, 1.2)
    ax.set_ylim(-1.2, 1.2)
    ax.set_aspect("equal")
    format_axes(ax)
    return save_figure(fig, problem.outfolder, "hudson", po)


def plot_lune(problem, po: PlotOptions | None = None, n_samples=500):
    """Posterior cloud on the Tape & Tape lune (reference ``lune``)."""
    import matplotlib.pyplot as plt

    po = po or PlotOptions()
    m6s = _posterior_m6s(problem, po, n_samples)
    gd = np.array([lune_coords(m6) for m6 in m6s])

    fig, ax = plt.subplots(figsize=(4, 6))
    ax.plot([-30, -30, 30, 30, -30], [-90, 90, 90, -90, -90], "k", lw=0.8)
    ax.scatter(gd[:, 0], gd[:, 1], s=6, alpha=0.3, color="#2c7fb8")
    ax.set_xlabel("lune longitude γ [deg]")
    ax.set_ylabel("lune latitude δ [deg]")
    ax.set_xlim(-35, 35)
    ax.set_ylim(-95, 95)
    format_axes(ax)
    return save_figure(fig, problem.outfolder, "lune", po)


def plot_fuzzy_mt_decomp(problem, po: PlotOptions | None = None, n_samples=500):
    """Posterior distributions of the ISO/DC/CLVD decomposition
    (reference ``fuzzy_mt_decomp``)."""
    import matplotlib.pyplot as plt

    from beat_tpu_torch.mt_utils import decompose

    po = po or PlotOptions()
    m6s = _posterior_m6s(problem, po, n_samples)
    parts = {"iso": [], "dc": [], "clvd": []}
    for m6 in m6s:
        d = decompose(m6)
        for k in parts:
            parts[k].append(d[k])

    fig, axes = plt.subplots(1, 3, figsize=(10, 3))
    for ax, (name, vals) in zip(axes, parts.items()):
        ax.hist(vals, bins=40, color="#2c7fb8", alpha=0.85)
        ax.set_xlabel(f"{name} [%]")
        format_axes(ax)
    fig.tight_layout()
    return save_figure(fig, problem.outfolder, "fuzzy_mt_decomp", po)


def beachball_image(m6s, grid_n: int = 151) -> np.ndarray:
    """Lower-hemisphere (Lambert equal-area) mean P-polarity image of a
    set of NED m6 tensors; NaN outside the unit circle."""
    x = np.linspace(-1, 1, grid_n)
    X, Y = np.meshgrid(x, x)
    R2 = X**2 + Y**2
    mask = R2 <= 1.0
    # inverse Lambert: takeoff from vertical
    r = np.sqrt(R2[mask])
    takeoff = 2.0 * np.arcsin(np.clip(r / np.sqrt(2.0), 0, 1))
    az = np.arctan2(X[mask], Y[mask])
    gamma = np.column_stack([
        np.sin(takeoff) * np.cos(az),
        np.sin(takeoff) * np.sin(az),
        np.cos(takeoff),
    ])  # NED, downward rays

    acc = np.zeros(gamma.shape[0])
    for m6 in m6s:
        amp = radiation_amplitude(np.asarray(m6) / np.abs(m6).max(), gamma)
        acc += np.sign(amp)
    img = np.full(X.shape, np.nan)
    img[mask] = acc / max(len(m6s), 1)
    return img


def plot_fuzzy_beachball(problem, po: PlotOptions | None = None, n_samples=200,
                         grid_n: int = 151):
    """
    Posterior-averaged P-polarity beachball: lower-hemisphere
    (Lambert azimuthal) image of the mean radiation sign over posterior
    MT samples (reference ``fuzzy_beachball``).
    """
    import matplotlib.pyplot as plt

    po = po or PlotOptions()
    m6s = _posterior_m6s(problem, po, n_samples)
    img = beachball_image(m6s, grid_n)

    fig, ax = plt.subplots(figsize=(5, 5))
    im = ax.imshow(img, extent=[-1, 1, -1, 1], origin="lower",
                   cmap="RdGy_r", vmin=-1, vmax=1)
    circle = plt.Circle((0, 0), 1.0, fill=False, color="k", lw=1.0)
    ax.add_patch(circle)
    ax.set_aspect("equal")
    ax.axis("off")
    fig.colorbar(im, ax=ax, shrink=0.7, label="mean P polarity")
    return save_figure(fig, problem.outfolder, "fuzzy_beachball", po)
