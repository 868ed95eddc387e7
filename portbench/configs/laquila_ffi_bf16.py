"""
The ``laquila_ffi_bf16`` configuration (sizes in ``laquila_ffi_bf16.json``):
``laquila_ffi``'s kinematic finite-fault inversion with its Green's-function
library stored in bfloat16, the storage the JAX package offers as
``BEAT_TPU_STACK_DTYPE=bfloat16``.  The library is built in that type
through the program's public classes (no environment variable); the
inputs are ``laquila_ffi``'s, and the plain reference stacks a library
of the same storage type (``reference/laquila_ffi_bf16.py``).
"""

from __future__ import annotations

import numpy as np

from portbench.configs.laquila_ffi import make_inputs  # noqa: F401 - the same inputs
from portbench.reference import laquila_ffi as reference
from portbench.reference import laquila_ffi_bf16

Reference = laquila_ffi_bf16.Reference


def build_problem(config: dict, inputs: dict, *, device, outfolder: str):
    """The program's Problem of this configuration on ``device``: the
    library is built on the device here, straight into the configuration's
    ``library_dtype``."""
    import torch

    from beat_tpu_torch.covariance import Covariance
    from beat_tpu_torch.ffi import discretize_sources, seis_construct_gf_linear
    from beat_tpu_torch.heart.gftable import build_homogeneous_table
    from beat_tpu_torch.heart.seismic import SeismicDataset, WaveformMapping
    from beat_tpu_torch.heart.taper import ArrivalTaper, Filter
    from beat_tpu_torch.models.distributer import SeismicDistributerComposite
    from beat_tpu_torch.models.laplacian import LaplacianDistributerComposite
    from beat_tpu_torch.models.problem import Problem
    from beat_tpu_torch.parameter import Parameter, PriorSet
    from beat_tpu_torch.sources import RectangularSource

    f, tb, lib, filt = config["fault"], config["table"], config["library"], config["filter"]
    plane = RectangularSource(length=f["n_strike"] * f["patch_size"],
                              width=f["n_dip"] * f["patch_size"], depth=f["depth"],
                              strike=f["strike"], dip=f["dip"], rake=f["rake"])
    fault = discretize_sources([plane], patch_length=f["patch_size"],
                               patch_width=f["patch_size"])
    table = build_homogeneous_table(reference.grid(tb["distances"]),
                                    reference.grid(tb["depths"]), nt=tb["nt"], dt=tb["dt"],
                                    vp=tb["vp"], vs=tb["vs"], rho=tb["rho"], device=device)
    east, north = inputs["station_east"], inputs["station_north"]
    n_win = config["window"]["samples"]
    datasets = [SeismicDataset(station=f"ST{i:02d}", channel="Z", east=east[i], north=north[i],
                               ydata=np.zeros(tb["nt"])) for i in range(len(east))]
    wavemap = WaveformMapping(name="any_P", datasets=datasets, table=table,
                              taper=ArrivalTaper(**reference.ffi_taper(n_win, tb["dt"])),
                              filterer=Filter(lower_corner=filt["lower"],
                                              upper_corner=filt["upper"], order=filt["order"]))
    library = seis_construct_gf_linear(
        table, wavemap, fault, component="uparr", duration_bounds=lib["duration_bounds"],
        duration_sampling=lib["duration_sampling"], starttime_bounds=lib["starttime_bounds"],
        starttime_sampling=lib["starttime_sampling"], shear_modulus=f["shear_modulus"],
        dtype=getattr(torch, config["library_dtype"]))
    wavemap.data_windows = np.asarray(inputs["data"], dtype=np.float32)
    for ds in wavemap.datasets:
        ds.covariance = Covariance(data=np.eye(n_win) * inputs["sd"] ** 2)
    seismic = SeismicDistributerComposite([(wavemap, {"uparr": library})], fault,
                                          slip_varnames=("uparr",),
                                          interpolation=lib["interpolation"], device=device)
    smoothing = LaplacianDistributerComposite(fault, slip_varnames=("uparr",), device=device)
    priors = PriorSet()
    for name, size, lower, upper in config["priors"]:
        priors.add(Parameter(name, [lower] * size, [upper] * size))
    return Problem(priors, {"seismic": seismic, "laplacian": smoothing}, device=device,
                   outfolder=outfolder)
