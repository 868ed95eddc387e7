"""
The ``fullmt`` configuration (sizes in ``fullmt.json``): a regional
full-moment-tensor inversion modelled on BEAT's FullMT example, at the
sizes the JSON file states (it lists each departure from the example),
assembled from the program's public classes.  The observed traces are made here from the
seed with the plain reference's analytic Green's functions, and both
the program and the reference read them.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import fullmt as reference

Reference = reference.Reference


def make_inputs(config: dict, rng: np.random.Generator) -> dict:
    """Stations and noisy raw traces of the true source, from ``rng``."""
    east, north = reference.stations(config, rng)
    raw = reference.true_traces(config, east, north)
    sd = config["noise_level"] * max(float(np.abs(r).max()) for r in raw.values())
    for ch in ("Z", "R", "T"):
        raw[ch] = raw[ch] + rng.normal(0.0, sd, raw[ch].shape)
    return {"station_east": east, "station_north": north, "raw": raw}


def true_row(config: dict) -> np.ndarray:
    """The flat row of the source behind the data, noise scales at h = 0."""
    t = config["truth"]
    m6 = reference.sdr_to_m6(t["strike"], t["dip"], t["rake"])
    values = dict(zip(reference.M6_NAMES, m6), magnitude=t["magnitude"], depth=t["depth"],
                  time=t["time"], duration=t["duration"])
    return np.array([values.get(p[0], 0.0) for p in config["priors"]])


def build_problem(config: dict, inputs: dict, *, device, outfolder: str):
    """The program's Problem of this configuration on ``device``."""
    from beat_tpu_torch.heart.gftable import build_homogeneous_table
    from beat_tpu_torch.heart.seismic import SeismicDataset, WaveformMapping
    from beat_tpu_torch.heart.taper import ArrivalTaper, Filter
    from beat_tpu_torch.models.problem import Problem
    from beat_tpu_torch.models.seismic import SeismicGeometryComposite
    from beat_tpu_torch.parameter import Parameter, PriorSet
    from beat_tpu_torch.sources import MTSource

    tb, truth, filt = config["table"], config["truth"], config["filter"]
    table = build_homogeneous_table(reference.grid(tb["distances"]),
                                    reference.grid(tb["depths"]), nt=tb["nt"], dt=tb["dt"],
                                    vp=tb["vp"], vs=tb["vs"], rho=tb["rho"], device=device)
    east, north, raw = inputs["station_east"], inputs["station_north"], inputs["raw"]
    wavemaps = []
    for number, wmap in enumerate(config["wavemaps"]):
        datasets = [SeismicDataset(station=f"ST{i:02d}", channel=ch, east=east[i],
                                   north=north[i], ydata=raw[ch][i])
                    for ch in wmap["channels"] for i in range(len(east))]
        wavemaps.append(WaveformMapping(
            name=wmap["name"], datasets=datasets, table=table,
            taper=ArrivalTaper(**config["taper"]),
            filterer=Filter(lower_corner=filt["lower"], upper_corner=filt["upper"],
                            order=filt["order"]),
            mapnumber=number))
    composite = SeismicGeometryComposite(
        wavemaps, [MTSource(depth=truth["depth"], magnitude=truth["magnitude"])],
        device=device)
    priors = PriorSet()
    for name, size, lower, upper in config["priors"]:
        priors.add(Parameter(name, [lower] * size, [upper] * size))
    return Problem(priors, {"seismic": composite}, device=device, outfolder=outfolder)
