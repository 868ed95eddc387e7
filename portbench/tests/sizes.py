"""
CPU sizes of the cells for the tests: every width the configurations
state is kept where the CPU allows, the grids, fault and populations
shrink.
"""

import copy
import json

from portbench.harness.catalog import PORTBENCH


def config(name: str) -> dict:
    return json.loads((PORTBENCH / "configs" / f"{name}.json").read_text())


def small_config(name: str) -> dict:
    """The configuration's keys that change at test size."""
    c = config(name)
    if name == "fullmt":
        # the real grid's spacing over the stations' distances, a shorter trace
        table = dict(c["table"], distances=[40e3, 150e3, 111], nt=128)
        return {"table": table, "stations": dict(c["stations"], n=4)}
    fault = dict(c["fault"], n_strike=6, n_dip=3)
    P = 18
    priors = copy.deepcopy(c["priors"])
    for p in priors:
        if p[1] == 500:
            p[1] = P
    priors[3][3], priors[4][3] = 12e3, 6e3
    return {"fault": fault, "table": dict(c["table"], nt=256), "window": {"samples": 64},
            "stations": dict(c["stations"], n=3), "priors": priors}


#: the traffic at test size, by cell
TRAFFIC = {"fullmt-smc": {"n_chains": 64, "n_steps": 20},
           "ffi-smc": {"n_chains": 48, "n_steps": 60, "buffer_thinning": 20},
           "ffi-smc-fulltrace": {"n_chains": 48, "n_steps": 20}}
CELL = {"fullmt-smc": {"judge": {"rows": 64, "block": 32}, "trace": {"stage": 1, "skip": 2,
                                                                     "steps": 3}},
        "ffi-smc": {"judge": {"rows": 32, "block": 16}, "trace": {"stage": 1, "skip": 1,
                                                                  "steps": 2}},
        "ffi-smc-fulltrace": {"judge": {"rows": 32, "block": 16},
                              "trace": {"stage": 1, "skip": 1, "steps": 2}}}


def overrides(cell: dict) -> dict:
    return {"config": small_config(cell["config"]), "traffic": TRAFFIC[cell["name"]],
            "cell": CELL[cell["name"]]}
