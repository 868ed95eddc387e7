"""The plain references against the program on seeded inputs at test
size, and the controls: a lower precision fails the comparison."""

import json

import numpy as np
import pytest
import torch

from portbench.harness import catalog, judge
from portbench.tests import sizes

CASES = {"fullmt": "fullmt-smc", "laquila_ffi": "ffi-smc"}


def limit(config_name: str) -> float:
    path = catalog.PORTBENCH / "workloads" / f"{CASES[config_name]}.json"
    return json.loads(path.read_text())["limits"]["llk_gap"]


def setup(config_name: str, seed: int):
    module = catalog.load_module("configs", config_name)
    config = dict(sizes.config(config_name), **sizes.small_config(config_name))
    inputs = module.make_inputs(config, np.random.default_rng(seed))
    return module, config, inputs


def program_llk(module, config, inputs, q, tmp_path):
    problem = module.build_problem(config, inputs, device="cpu", outfolder=str(tmp_path))
    logp, data = problem.make_logp_fn()
    with torch.no_grad():
        return logp(torch.as_tensor(q, dtype=torch.float32), data).double().numpy()


def prior_rows(config, n, seed):
    lo = np.concatenate([[p[2]] * p[1] for p in config["priors"]])
    hi = np.concatenate([[p[3]] * p[1] for p in config["priors"]])
    return np.random.default_rng(seed).uniform(lo, hi, (n, lo.size)).astype(np.float32)


def gaps(reference, q, port):
    llk, scale, alt = judge.reference_llk(reference, q, 16)
    return judge.llk_gaps(port, llk, scale, alt)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("config_name", sorted(CASES))
def test_reference_agrees_with_the_program(config_name, seed, tmp_path):
    module, config, inputs = setup(config_name, seed)
    q = prior_rows(config, 48, seed + 100)
    port = program_llk(module, config, inputs, q, tmp_path)
    got = gaps(module.Reference(config, inputs, "cpu"), q, port)
    assert got.max() <= limit(config_name), got.max()


@pytest.mark.parametrize("config_name", sorted(CASES))
def test_control_in_tf32_fails_the_comparison(config_name):
    module, config, inputs = setup(config_name, 5)
    q = prior_rows(config, 48, 7)
    exact = module.Reference(config, inputs, "cpu")
    control = judge.reference_llk(module.Reference(config, inputs, "cpu", precision="tf32"),
                                  q, 16)[0]
    assert gaps(exact, q, control).max() > limit(config_name)


def test_program_on_a_bf16_library_fails_the_comparison(monkeypatch, tmp_path):
    module, config, inputs = setup("laquila_ffi", 6)
    q = prior_rows(config, 48, 8)
    monkeypatch.setenv("BEAT_TPU_STACK_DTYPE", "bfloat16")
    port = program_llk(module, config, inputs, q, tmp_path)
    assert gaps(module.Reference(config, inputs, "cpu"), q, port).max() > limit("laquila_ffi")


def test_tf32_rounding():
    from portbench.reference.common import tf32_round

    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0e-5, float("inf")])
    got = tf32_round(x)
    assert got[0] == 1.0 and got[1] == 1.0 and got[2] == 1.0 + 4 * 2**-11
    assert (got.view(torch.int32)[:4] & 0x1FFF).eq(0).all() and torch.isinf(got[4])


def test_stage_arithmetic():
    from portbench.reference.common import (importance_weights, next_beta,
                                            systematic_count_violations)

    llks = np.random.default_rng(0).normal(0, 50, 1000)
    beta = next_beta(0.0, llks, 1.0)
    w = importance_weights(0.0, beta, llks)
    assert 0 < beta < 1 and abs(np.std(w) / np.mean(w) - 1.0) < 1e-3
    u = 0.37
    parents = np.searchsorted(np.cumsum(w), (np.arange(1000) + u) / 1000)
    assert systematic_count_violations(w, parents) == 0
    assert systematic_count_violations(w, np.sort(parents[::-1].copy()[:1000] * 0)) > 0
