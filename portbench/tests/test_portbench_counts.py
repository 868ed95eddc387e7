"""The roofline counts at the inputs of ``PERF.md``'s kernel table
reproduce the bounds ``chip_smoke.py`` printed for them: K1c 0.0793 ms on
the main path's 60,000 queries, K3 1.2207 ms on the Laquila library at
2000 chains of random durations and onsets."""

import numpy as np
import pytest
import torch

from portbench.counts import k1c, k3
from portbench.counts.peaks import least_seconds


class Captured(Exception):
    pass


def test_k1c_count_at_the_main_path_queries(tmp_path):
    from beat_tpu_torch.flagship import REAL_SIZE, build_flagship

    # chip_smoke.py's [k1c]: the FullMT problem of seed 0, one 2000-chain
    # likelihood over the prior (1 % in from each bound, default_rng(3))
    problem = build_flagship(**REAL_SIZE, seed=0, device="cpu", outfolder=str(tmp_path))
    table = problem.composites["seismic"].tables[0]
    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    span = upper - lower
    q = torch.as_tensor(np.random.default_rng(3).uniform(
        lower + 0.01 * span, upper - 0.01 * span, size=(2000, lower.size)), dtype=torch.float32)
    got = {}

    def capture(tbl, cd, z0, A):
        got.update(table=tuple(tbl.shape), cd=cd, z0=z0)
        raise Captured

    table.contract_fn = capture
    with pytest.raises(Captured), torch.no_grad():
        logp(q, data)
    n_bytes, flops, peak = k1c.work(got["table"], got["cd"], got["z0"])
    assert got["cd"].numel() == 60_000
    assert round(1e3 * least_seconds(n_bytes, flops, peak), 4) == 0.0793


def test_k3_count_at_the_laquila_library():
    T, P, D, S, N, C = 12, 500, 10, 32, 512, 2000
    gen = torch.Generator().manual_seed(13)
    durations = 0.2 + 5.3 * torch.rand((C, P), generator=gen)
    onsets = -0.5 + 9.5 * torch.rand((C, T, P), generator=gen)
    # the library's multilinear quantisation: the upper cell, clipped
    didx = torch.clamp(torch.ceil((durations - 0.5) / 0.5), 1, D - 1).to(torch.int32)
    sidx = torch.clamp(torch.ceil(onsets / 0.25), 1, S - 1).to(torch.int32)
    n_bytes, flops, peak = k3.work((T, P, D, S, N), 4, didx, sidx, True)
    assert round(1e3 * least_seconds(n_bytes, flops, peak), 4) == 1.2207
    # every cell of the library is touched: the bytes are the library's
    assert n_bytes > T * P * D * S * N * 4


def test_llk_flops_count_the_kernels_work():
    import json

    from portbench.harness import catalog

    cfg = json.loads((catalog.PORTBENCH / "configs" / "fullmt.json").read_text())
    per_chain = catalog.load_module("counts", "fullmt").llk_flops(cfg)
    assert per_chain > 30 * 2 * 24 * 1026          # K1c's share of 30 targets
    ffi = json.loads((catalog.PORTBENCH / "configs" / "laquila_ffi.json").read_text())
    assert catalog.load_module("counts", "laquila_ffi").llk_flops(ffi) > 2 * 4 * 12 * 500 * 512
