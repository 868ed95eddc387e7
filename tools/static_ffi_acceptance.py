#!/usr/bin/env python3
"""
Acceptance of the static finite-fault SMC from its NNLS start, in both
packages on the same problem: the port's static FFI flagship
(``beat_tpu_torch.flagship.build_static_ffi_flagship``) and its JAX twin
built from the same arrays (datasets, covariances, library, fault), each
sampled as ``chip_smoke.py`` [static_ffi_smc] samples it:
``initialization="lsq"``, 20 steps a stage, capped at 3 stages, buffers
thinned by 10.  Runs on the CPU.

    python3 tools/static_ffi_acceptance.py [--n-strike 25] [--n-dip 5]
        [--points 500] [--chains 500]

Prints one JSON line per package (β and acceptance per stage, NNLS and
wall seconds) and the settings.  It answers whether the JAX package's
SMC also stands still (acceptance 0) from the NNLS start, as the port's
does at the real size on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

STEPS, MAX_STAGES, THINNING, SEED = 20, 4, 10, 1


def jax_twin(port, outfolder: str):
    """The JAX package's Problem on the port problem's arrays."""
    import jax.numpy as jnp

    from beat_tpu.covariance import Covariance
    from beat_tpu.ffi import fault as jfault
    from beat_tpu.ffi.gflibrary import GeodeticGFLibrary
    from beat_tpu.heart.geodesy import GeodeticDataset
    from beat_tpu.models.distributer import GeodeticDistributerComposite
    from beat_tpu.models.laplacian import LaplacianDistributerComposite
    from beat_tpu.models.problem import Problem
    from beat_tpu.parameter import Parameter, PriorSet
    from beat_tpu.sources import RectangularSource

    comp = port.composites["geodetic"]
    datasets = [GeodeticDataset(name=ds.name, typ=ds.typ, coords=ds.coords,
                                displacement=ds.displacement, los_vector=ds.los_vector,
                                odw=ds.odw, covariance=Covariance(data=ds.covariance.data))
                for ds in comp.datasets]
    names = comp.gflibrary.component_names
    lib = GeodeticGFLibrary(gfs={c: jnp.asarray(comp.gflibrary.gf(c).cpu().numpy())
                                 for c in names}, component_names=list(names))
    planes = [RectangularSource(**{k: v for k, v in sf.plane.to_dict().items() if k != "type"})
              for sf in comp.fault.subfaults]
    sf0 = comp.fault.subfaults[0]
    fault = jfault.discretize_sources(planes, sf0.patch_length, sf0.patch_width,
                                      components=tuple(names))
    priors = PriorSet()
    for p in port.source_priors.parameters.values():
        priors.add(Parameter(p.name, p.lower, p.upper))
    problem = Problem(priors, {"geodetic": GeodeticDistributerComposite(datasets, lib, fault),
                               "laplacian": LaplacianDistributerComposite(
                                   fault, slip_varnames=tuple(names))},
                      outfolder=outfolder, initialization="lsq")
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
    ap.add_argument("--n-strike", type=int, default=25)
    ap.add_argument("--n-dip", type=int, default=5)
    ap.add_argument("--points", type=int, default=500)
    ap.add_argument("--chains", type=int, default=500)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    from beat_tpu.backend import SampleStage as JStage
    from beat_tpu.samplers import SMCParams as JParams
    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.flagship import build_static_ffi_flagship
    from beat_tpu_torch.samplers import SMCParams

    kw = dict(n_chains=args.chains, n_steps=STEPS, max_stages=MAX_STAGES,
              buffer_thinning=THINNING, seed=SEED)
    with tempfile.TemporaryDirectory() as work:
        port = build_static_ffi_flagship(args.n_strike, args.n_dip, args.points, seed=0,
                                         device="cpu", outfolder=os.path.join(work, "port"))
        twin = jax_twin(port, os.path.join(work, "jax"))
        print(json.dumps(dict(settings=dict(vars(args), dims=port.ordering.size, steps=STEPS,
                                            stages=MAX_STAGES - 1, thinning=THINNING))))
        for label, problem, params, stage_cls in (("jax", twin, JParams(**kw), JStage),
                                                   ("port", port, SMCParams(**kw), SampleStage)):
            t0 = time.perf_counter()
            problem.composites["geodetic"].lsq_solution()
            nnls_s = time.perf_counter() - t0
            r = run(problem, params, stage_cls)
            print(json.dumps(dict(package=label, nnls_s=round(nnls_s, 3), **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
