#!/usr/bin/env python3
"""
Acceptance of the kinematic finite-fault SMC at the example's settings,
in both packages on the same problem: the port's kinematic FFI flagship
(``beat_tpu_torch.flagship.build_ffi_flagship``: slip, duration and
rupture velocity per patch, the nucleation point, a Laplacian smoothness
prior) cut to a few targets and short windows, and its JAX twin built
from the same arrays (library, observed windows, covariances, fault),
each sampled as ``chip_smoke.py`` [ffi_smc] samples it: random walk, 20
steps a stage, capped at 3 stages (``examples/laquila_scale_ffi.py``).
Runs on the CPU.

    python3 tools/kinematic_ffi_acceptance.py [--targets 4] [--n-strike 10]
        [--n-dip 5] [--nt 512] [--nwin 384] [--chains 300]

The defaults make a library of 4 × 50 × 10 × 32 × 384 float32 samples
(98 MB).  Prints one JSON line per package (β and acceptance per stage,
wall seconds) and the settings.  It answers whether the JAX package's
kinematic SMC moves (acceptance above 0) where the port's stands still.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

STEPS, MAX_STAGES, SEED = 20, 4, 1


def jax_twin(port, outfolder: str):
    """The JAX package's Problem on the port problem's arrays."""
    import jax.numpy as jnp
    import numpy as np

    from beat_tpu.covariance import Covariance
    from beat_tpu.ffi import SeismicGFLibrary, discretize_sources
    from beat_tpu.heart.gftable import build_homogeneous_table
    from beat_tpu.heart.seismic import SeismicDataset, WaveformMapping
    from beat_tpu.heart.taper import ArrivalTaper, Filter
    from beat_tpu.models.distributer import SeismicDistributerComposite
    from beat_tpu.models.laplacian import LaplacianDistributerComposite
    from beat_tpu.models.problem import Problem
    from beat_tpu.parameter import Parameter, PriorSet
    from beat_tpu.sources import RectangularSource
    from beat_tpu_torch import flagship

    comp = port.composites["seismic"]
    pw = comp.wavemaps[0]
    d0, d1, nd = flagship.FFI_DISTANCES
    z0, z1, nz = flagship.FFI_DEPTHS
    table = build_homogeneous_table(distances=np.linspace(d0, d1, nd),
                                    depths=np.linspace(z0, z1, nz), nt=pw.table.nt,
                                    dt=flagship.FFI_DT)
    t = pw.taper
    wmap = WaveformMapping(
        name=pw.name, table=table, taper=ArrivalTaper(a=t.a, b=t.b, c=t.c, d=t.d),
        filterer=Filter(**flagship.FFI_FILTER),
        datasets=[SeismicDataset(station=d.station, channel=d.channel, east=d.east,
                                 north=d.north, ydata=np.zeros(table.nt))
                  for d in pw.datasets])
    assert np.array_equal(wmap.window_starts, pw.window_starts)
    wmap.data_windows = np.array(pw.data_windows)
    for jd, d in zip(wmap.datasets, pw.datasets):
        jd.covariance = Covariance(data=np.array(d.covariance.data))
    plib = comp.libs[0]["uparr"]
    lib = SeismicGFLibrary(data=jnp.asarray(plib.data.cpu().numpy()),
                           duration_min=plib.duration_min,
                           duration_sampling=plib.duration_sampling,
                           starttime_min=plib.starttime_min,
                           starttime_sampling=plib.starttime_sampling)
    plane = comp.fault.subfaults[0].plane
    fault = discretize_sources(
        [RectangularSource(**{k: v for k, v in plane.to_dict().items() if k != "type"})],
        patch_length=flagship.FFI_PATCH, patch_width=flagship.FFI_PATCH)
    priors = PriorSet()
    for p in port.source_priors.parameters.values():
        priors.add(Parameter(p.name, p.lower, p.upper))
    problem = Problem(priors, {
        "seismic": SeismicDistributerComposite([(wmap, {"uparr": lib})], fault,
                                               interpolation=comp.interpolation,
                                               use_pallas=False),
        "laplacian": LaplacianDistributerComposite(fault)}, outfolder=outfolder)
    assert problem.ordering.names == port.ordering.names
    return problem


def run(problem, params, stage_cls) -> dict:
    """Sample to the stage cap; β and acceptance of every stage run."""
    t0 = time.perf_counter()
    try:
        problem.sample(params)
        capped = False
    except RuntimeError as e:
        if "did not reach beta=1" not in str(e):
            raise
        capped = True
    wall = time.perf_counter() - t0
    handler = stage_cls(problem.outfolder, ordering=problem.ordering)
    stages = range(1, MAX_STAGES) if capped else [-1]
    states = [handler.load_state(st) for st in stages]
    return dict(capped=capped, wall_s=round(wall, 2),
                betas=[round(float(st["beta"]), 6) for st in states],
                acceptance=[round(float(a), 4) for a in states[-1]["acceptance"]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--targets", type=int, default=4)
    ap.add_argument("--n-strike", type=int, default=10)
    ap.add_argument("--n-dip", type=int, default=5)
    ap.add_argument("--nt", type=int, default=512)
    ap.add_argument("--nwin", type=int, default=384)
    ap.add_argument("--chains", type=int, default=300)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    from beat_tpu.backend import SampleStage as JStage
    from beat_tpu.samplers import SMCParams as JParams
    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.flagship import build_ffi_flagship
    from beat_tpu_torch.samplers import SMCParams

    kw = dict(n_chains=args.chains, n_steps=STEPS, max_stages=MAX_STAGES, seed=SEED)
    with tempfile.TemporaryDirectory() as work:
        port = build_ffi_flagship(args.targets, args.n_strike, args.n_dip, args.nt, args.nwin,
                                  seed=0, device="cpu", outfolder=os.path.join(work, "port"))
        twin = jax_twin(port, os.path.join(work, "jax"))
        lib = port.composites["seismic"].libs[0]["uparr"].data
        print(json.dumps(dict(settings=dict(vars(args), dims=port.ordering.size, steps=STEPS,
                                            stages=MAX_STAGES - 1,
                                            library_MB=round(lib.numel() * 4 / 1e6, 1)))))
        for label, problem, params, stage_cls in (("jax", twin, JParams(**kw), JStage),
                                                   ("port", port, SMCParams(**kw), SampleStage)):
            print(json.dumps(dict(package=label, **run(problem, params, stage_cls))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
