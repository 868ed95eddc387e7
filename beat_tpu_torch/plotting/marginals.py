"""Posterior marginal plots (copied from ``beat_tpu/plotting/marginals.py``;
reference ``beat/plotting/marginals.py``)."""

from __future__ import annotations

import numpy as np

from beat_tpu_torch.plotting.common import PlotOptions, histplot_op, save_figure


def plot_stage_posteriors(problem, po: PlotOptions | None = None, stages=None,
                          max_vars: int = 40):
    """One marginal histogram panel per variable, optionally overlaying
    several SMC stages (reference ``stage_posteriors``): MAP marker, 94 %
    HDI band, mean ± sd annotation, and the prior bounds as the x-range
    so tight posteriors read against their prior."""
    import matplotlib.pyplot as plt

    from beat_tpu_torch.backend import SampleStage, hdi

    po = po or PlotOptions()
    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    stages = stages or [po.load_stage]

    try:
        lower, upper = problem.priors.bounds_arrays()
    except Exception:
        lower = upper = None

    all_specs = [(spec, k) for spec in problem.ordering.vmap
                 if not po.varnames or spec.name in po.varnames
                 for k in range(max(1, int(np.prod(spec.shape, dtype=int))))]
    if po.varnames and not all_specs:
        raise ValueError(f"varnames {po.varnames} match no sampled "
                         f"variable ({list(problem.ordering.names)})")
    pages = [all_specs[i:i + max_vars]
             for i in range(0, len(all_specs), max_vars)] or [[]]
    colors = plt.cm.viridis(np.linspace(0.2, 0.9, len(stages)))

    # one disk read per stage, not per page (an FFI problem can have
    # dozens of pages over the same trace)
    stage_data = []
    for stage in stages:
        trace = handler.load_trace(stage)
        flat = trace.q_trace.reshape(-1, trace.q_trace.shape[-1])
        llk_flat = trace.llk_trace.reshape(-1)
        stage_data.append((flat, flat[int(np.argmax(llk_flat))]))

    paths = []
    for page_no, specs in enumerate(pages):
        n = len(specs)
        ncols = min(4, n)
        nrows = (n + ncols - 1) // ncols
        fig, axes = plt.subplots(nrows, ncols,
                                 figsize=(3.2 * ncols, 2.4 * nrows),
                                 squeeze=False)
        for si, (flat, q_map) in enumerate(stage_data):
            final = si == len(stages) - 1
            for i, (spec, k) in enumerate(specs):
                ax = axes[i // ncols][i % ncols]
                col = int(np.arange(flat.shape[1])[spec.slc][k])
                samples = flat[:, col]
                ref = None
                if po.reference and spec.name in po.reference:
                    ref = np.atleast_1d(po.reference[spec.name])[k]
                histplot_op(ax, samples, reference=ref, color=colors[si])
                name = spec.name if spec.shape == () else f"{spec.name}[{k}]"
                if final:
                    lo, hi = hdi(samples)
                    ax.axvspan(lo, hi, color=colors[si], alpha=0.15, lw=0)
                    ax.axvline(q_map[col], color="k", lw=1.0, ls="--")
                    ax.set_title(
                        f"{name}  {samples.mean():.3g}"
                        f"±{samples.std(ddof=1):.2g}", fontsize=8)
                    if lower is not None and lower[col] < upper[col]:
                        pad = 0.02 * (upper[col] - lower[col])
                        ax.set_xlim(lower[col] - pad, upper[col] + pad)
                        # prior overlay: the Uniform prior's density
                        # level — posteriors that stay at this line are
                        # prior-dominated (reference draws the prior
                        # pdf in stage_posteriors)
                        ax.hlines(1.0 / (upper[col] - lower[col]),
                                  lower[col], upper[col], color="0.45",
                                  ls=":", lw=1.0)
                ax.set_yticks([])
        for j in range(n, nrows * ncols):
            axes[j // ncols][j % ncols].axis("off")
        fig.tight_layout()
        suffix = "" if len(pages) == 1 else f"_p{page_no + 1}"
        paths.append(save_figure(fig, problem.outfolder,
                                 f"stage_posteriors{suffix}", po))
    return paths[0] if len(paths) == 1 else paths


def plot_correlation_hist(problem, po: PlotOptions | None = None, varnames=None,
                          max_vars: int = 8):
    """Corner plot: marginals on the diagonal, 2-d density off-diagonal
    (reference ``correlation_hist``)."""
    import matplotlib.pyplot as plt

    from beat_tpu_torch.backend import SampleStage

    po = po or PlotOptions()
    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    trace = handler.load_trace(po.load_stage)
    flat = trace.q_trace.reshape(-1, trace.q_trace.shape[-1])

    varnames = varnames or po.varnames
    specs = []
    for spec in problem.ordering.vmap:
        if varnames and spec.name not in varnames:
            continue
        for k in range(max(1, int(np.prod(spec.shape, dtype=int)))):
            specs.append((spec, k))
    specs = specs[:max_vars]
    n = len(specs)
    llk_flat = trace.llk_trace.reshape(-1)
    q_map = flat[int(np.argmax(llk_flat))]
    cols = [int(np.arange(flat.shape[1])[s.slc][k]) for s, k in specs]
    fig, axes = plt.subplots(n, n, figsize=(2.2 * n, 2.2 * n), squeeze=False)
    for i, (si, ki) in enumerate(specs):
        xi = flat[:, cols[i]]
        for j, (sj, kj) in enumerate(specs):
            ax = axes[i][j]
            if i == j:
                histplot_op(ax, xi)
                ax.axvline(q_map[cols[i]], color="k", lw=1.0, ls="--")
                ax.set_yticks([])
            elif j < i:
                xj = flat[:, cols[j]]
                ax.hist2d(xj, xi, bins=30, cmap="Blues")
                ax.plot(q_map[cols[j]], q_map[cols[i]], "x", color="crimson",
                        ms=7, mew=1.8)
            else:
                # posterior correlation coefficient (reference upper panel)
                xj = flat[:, cols[j]]
                r = float(np.corrcoef(xj, xi)[0, 1]) if xi.std() and xj.std() \
                    else 0.0
                ax.text(0.5, 0.5, f"{r:+.2f}", transform=ax.transAxes,
                        ha="center", va="center",
                        fontsize=9 + 6 * abs(r),
                        color=plt.cm.coolwarm(0.5 * (1 + r)))
                ax.axis("off")
            if i == n - 1 and j <= i:
                name = sj.name if sj.shape == () else f"{sj.name}[{kj}]"
                ax.set_xlabel(name, fontsize=8)
            if j == 0:
                name = si.name if si.shape == () else f"{si.name}[{ki}]"
                ax.set_ylabel(name, fontsize=8)
    fig.tight_layout()
    return save_figure(fig, problem.outfolder, "correlation_hist", po)
