"""
3-D slip-distribution plots (copied from ``beat_tpu/plotting/bem.py``;
reference ``beat/plotting/bem.py``
``slip_distribution_3d`` and the FFI 3-D slip view
``plotting/ffi.py:926``): triangular BEM meshes colored per slip
component, or rectangular fault patches colored by slip magnitude.
"""

from __future__ import annotations

import numpy as np

from beat_tpu_torch.plotting.common import PlotOptions, save_figure

km = 1000.0


def response_slip_vectors(engine, response):
    """Scatter the BC-ordered slip solution into per-mesh (ntri, 3)
    strike/dip/normal arrays (the solve concatenates one block per
    boundary condition; reference keeps them as ``slip_vectors``)."""
    from beat_tpu_torch.bem.base import slip_comp_to_idx

    out = [np.zeros((m.ntriangles, 3)) for m in response.meshes]
    slips = response.slips.double().cpu().numpy()
    offset = 0
    for bc in engine.boundary_conditions:
        comp = slip_comp_to_idx[bc.slip_component]
        for i in bc.source_idxs:
            n = response.meshes[i].ntriangles
            out[i][:, comp] = slips[offset:offset + n]
            offset += n
    return out


def _equal_3d(ax, mins, maxs):
    ctr = (mins + maxs) / 2.0
    r = float((maxs - mins).max()) / 2.0 or 1.0
    ax.set_xlim(ctr[0] - r, ctr[0] + r)
    ax.set_ylim(ctr[1] - r, ctr[1] + r)
    ax.set_zlim(ctr[2] - r, ctr[2] + r)


def draw_3d_slip_distribution(meshes, slip_vectors, perspective="150/30",
                              fig=None):
    """Render triangle meshes colored by strike/dip/normal slip
    (reference ``slip_distribution_3d`` ``plotting/bem.py:17``: seismic
    cmap for shear components, hot for opening; unit-vector quivers)."""
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    azimuth, elevation = (float(a) for a in perspective.split("/"))
    fig = fig or plt.figure(figsize=(11, 4))
    comps = ("strike", "dip", "normal")
    tris = np.concatenate([m.triangles for m in meshes]) / km
    mins, maxs = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    for j, comp in enumerate(comps):
        cmap = "hot" if comp == "normal" else "seismic"
        ax = fig.add_subplot(1, 3, j + 1, projection="3d")
        for mesh, slips3 in zip(meshes, slip_vectors):
            coll = Poly3DCollection(mesh.triangles / km)
            a = np.asarray(slips3)[:, j]
            vmax = float(np.abs(a).max())
            if vmax == 0.0:
                coll.set_facecolor("white")
                coll.set(edgecolor="k", linewidth=0.1, alpha=0.25)
            else:
                coll.set_cmap(plt.get_cmap(cmap))
                coll.set_array(a)
                if comp == "normal":
                    coll.set_clim(float(a.min()), float(a.max()))
                else:
                    coll.set_clim(-vmax, vmax)
                coll.set(edgecolor="k", linewidth=0.2, alpha=0.75)
                fig.colorbar(coll, ax=ax, shrink=0.5, pad=0.1,
                             label=f"{comp}-slip [m]")
                vecs = getattr(mesh, f"unit_{comp}_vectors",
                               None) if comp != "normal" else mesh.normals
                if vecs is not None:
                    c = mesh.centroids / km
                    ax.quiver(c[::3, 0], c[::3, 1], c[::3, 2],
                              vecs[::3, 0], vecs[::3, 1], vecs[::3, 2],
                              color="k", length=0.3, linewidth=0.8)
            ax.add_collection3d(coll)
        _equal_3d(ax, mins, maxs)
        ax.view_init(elev=elevation, azim=azimuth)
        ax.set_xlabel("E [km]")
        ax.set_ylabel("N [km]")
        ax.set_zlabel("Z [km]")
        ax.set_title(comp, fontsize=9)
    return fig


def fault_patch_quads(fault):
    """(npatches, 4, 3) ENU corner quads of all rectangular patches
    (z up: plot height = −depth)."""
    quads = []
    for p in fault.get_all_patches():
        top = np.array([p.east_shift, p.north_shift, -p.depth])
        sv = p.strikevector * p.length / 2.0
        dv = p.dipvector * p.width
        quads.append([top - sv, top + sv, top + sv + dv, top - sv + dv])
    return np.asarray(quads)


def plot_slip_distribution_3d(problem, po: PlotOptions | None = None,
                              point=None, perspective="150/30"):
    """
    3-D posterior-mean slip view.  BEM problems render per-component
    triangle meshes (reference ``plotting/bem.py``); FFI/geometry
    problems render rectangular patches colored by slip magnitude with
    the slip colormap (reference ``plotting/ffi.py:926`` GMT view).
    """
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.plotting.colormap import slip_colormap

    po = po or PlotOptions()
    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    trace = handler.load_trace(po.load_stage)
    flat = trace.q_trace.reshape(-1, trace.q_trace.shape[-1])
    mean_point = problem.ordering.to_point(flat.mean(axis=0))
    if point is not None:
        mean_point.update(point)
    mean_np = {k: np.asarray(v) for k, v in mean_point.items()}

    bem = next((c for c in problem.composites.values()
                if hasattr(c, "engine")), None)
    if bem is not None:
        sources = (bem._apply_point_np(mean_np)
                   if hasattr(bem, "_apply_point_np") else bem.sources)
        response = bem.engine.process(sources, bem.stack.coords)
        if not response.is_valid:
            raise ValueError("posterior-mean BEM geometry is invalid "
                             "(mesh intersection)")
        slip_vectors = response_slip_vectors(bem.engine, response)
        fig = draw_3d_slip_distribution(response.meshes, slip_vectors,
                                        perspective)
        return save_figure(fig, problem.outfolder, "slip_distribution_3d", po)

    fault = next((c.fault for c in problem.composites.values()
                  if hasattr(c, "fault")), None)
    if fault is None:
        raise ValueError("slip_distribution_3d needs a BEM engine or a "
                         "fault geometry in the problem composites")

    uparr = np.asarray(np.atleast_1d(mean_np.get("uparr",
                                                 np.zeros(fault.npatches))))
    uperp = np.asarray(np.atleast_1d(mean_np.get("uperp", 0.0)))
    slip = np.sqrt(uparr**2 + np.resize(uperp, uparr.shape) ** 2)

    azimuth, elevation = (float(a) for a in perspective.split("/"))
    quads = fault_patch_quads(fault) / km
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    coll = Poly3DCollection(quads)
    coll.set_cmap(slip_colormap())
    coll.set_array(slip)
    coll.set_clim(0.0, max(float(slip.max()), 1e-12))
    coll.set(edgecolor="k", linewidth=0.3)
    ax.add_collection3d(coll)
    fig.colorbar(coll, ax=ax, shrink=0.6, label="slip [m]")
    pts = quads.reshape(-1, 3)
    _equal_3d(ax, pts.min(0), pts.max(0))
    ax.view_init(elev=elevation, azim=azimuth)
    ax.set_xlabel("E [km]")
    ax.set_ylabel("N [km]")
    ax.set_zlabel("Z [km]")
    return save_figure(fig, problem.outfolder, "slip_distribution_3d", po)
