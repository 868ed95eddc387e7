"""
The ``laquila_ffi`` configuration (sizes in ``laquila_ffi.json``): a
kinematic finite-fault inversion modelled on BEAT's L'Aquila example, at
the sizes the JSON file states (it lists each departure from the
example), assembled from the program's public classes.  The
observed windows are made here from the seed with the plain reference's
forward, and both the program and the reference read them.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import laquila_ffi as reference

Reference = reference.Reference


def make_inputs(config: dict, rng: np.random.Generator) -> dict:
    """Stations, the true rupture and the noisy observed windows, from
    ``rng``; ``sd`` is the noise's standard deviation."""
    f, t = config["fault"], config["truth"]
    east, north = reference.stations(config, rng)
    n_s, n = f["n_strike"], f["n_strike"] * f["n_dip"]
    slips = rng.uniform(*t["slip_range"], n) * np.exp(
        -((np.arange(n) % n_s - n_s / 2) ** 2) / (n_s / 3) ** 2)
    truth = {"uparr": slips,
             "durations": np.round(rng.uniform(*t["duration_range"], n) * 2) / 2,
             "velocities": np.full(n, t["velocity"]),
             "nucleation_strike": np.array([t["nucleation_strike_share"] * n_s * f["patch_size"]]),
             "nucleation_dip": np.array([t["nucleation_dip"]])}
    inputs = {"station_east": east, "station_north": north, "truth": truth}
    synth = reference.true_windows(config, inputs, "cpu")
    sd = config["noise_level"] * float(np.abs(synth).max())
    inputs["data"] = (synth + rng.normal(0.0, sd, synth.shape)).astype(np.float32)
    inputs["sd"] = sd
    return inputs


def build_problem(config: dict, inputs: dict, *, device, outfolder: str):
    """The program's Problem of this configuration on ``device``: the
    library is built on the device here."""
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
        starttime_sampling=lib["starttime_sampling"], shear_modulus=f["shear_modulus"])
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
