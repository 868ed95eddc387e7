"""
Interop with original-BEAT project artifacts (copied from
``beat_tpu/interop.py``; the GF builds and the trace gridding of an
import run on the ``device`` they are given).

Reads the reference framework's on-disk formats WITHOUT pyrocko, pymc or
pytensor installed, so existing BEAT projects migrate with one command
(``beat-tpu import <dest> --from_beat <src>``):

* guts-YAML configs (``config_geometry.yaml`` trees tagged ``!beat.*`` /
  ``!pf.*``; reference ``beat/config.py:2294-2336`` reads them with
  pyrocko.guts) -> native :class:`beat_tpu_torch.config.BEATconfig`.
* pyrocko pickles (``seismic_data.pkl`` of ``[stations, SeismicDataset
  traces]``, reference ``models/seismic.py:94``; ``geodetic_data.pkl``
  of DiffIFG/GNSS objects, ``models/geodetic.py:80``) via a shim
  ``Unpickler`` that materialises attribute bags for pyrocko/beat/
  pytensor class names and extracts the numpy payloads.
* pyrocko "basic station" text files and snuffler marker files (the
  MTQT_polarity example inputs; reference ``PolarityMapping``
  ``heart.py:2721`` + ``load_and_blacklist_stations``).
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import types as _types

import numpy as np
import yaml

logger = logging.getLogger("beat_tpu_torch.interop")


# ---------------------------------------------------------------------------
# guts YAML -> plain dict trees
# ---------------------------------------------------------------------------


class _GutsLoader(yaml.SafeLoader):
    """SafeLoader accepting any ``!pkg.Class`` guts tag as a plain
    mapping/sequence/scalar (the reference's typed YAML parses as
    ordinary YAML once the tags are ignored)."""


def _construct_tagged(loader, tag_suffix, node):
    if isinstance(node, yaml.MappingNode):
        return loader.construct_mapping(node, deep=True)
    if isinstance(node, yaml.SequenceNode):
        return loader.construct_sequence(node, deep=True)
    return loader.construct_scalar(node)


_GutsLoader.add_multi_constructor("!", _construct_tagged)


def load_guts_yaml(path: str) -> dict:
    """Parse a pyrocko-guts YAML file into plain dicts (tags dropped)."""
    with open(path) as f:
        d = yaml.load(f, Loader=_GutsLoader)
    if not isinstance(d, dict):
        raise ValueError(f"{path} did not parse to a mapping")
    return d


def guts_time_to_epoch(value) -> float:
    """Epoch seconds from a guts time value: YAML may already have
    resolved it to a (naive, UTC) datetime, or it arrives as a string
    with up to nanosecond fractions (pyrocko ``str_to_time``)."""
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, datetime.datetime):
        return value.replace(tzinfo=datetime.timezone.utc).timestamp()
    if isinstance(value, datetime.date):
        dt = datetime.datetime(value.year, value.month, value.day)
        return dt.replace(tzinfo=datetime.timezone.utc).timestamp()
    s = str(value).strip()
    if "." in s:
        head, frac = s.rsplit(".", 1)
        s = head + "." + frac[:6]          # datetime caps at microseconds
        fmt = "%Y-%m-%d %H:%M:%S.%f"
    else:
        fmt = "%Y-%m-%d %H:%M:%S"
    dt = datetime.datetime.strptime(s, fmt)
    return dt.replace(tzinfo=datetime.timezone.utc).timestamp()


# ---------------------------------------------------------------------------
# guts config tree -> native BEATconfig
# ---------------------------------------------------------------------------


def _param_dict(d: dict) -> dict:
    """Native Parameter dict from a guts ``beat.heart.Parameter``."""
    from beat_tpu_torch.parameter import Parameter

    return Parameter(
        name=d["name"], lower=d["lower"], upper=d["upper"],
        testvalue=d.get("testvalue"), form=d.get("form", "Uniform"),
    ).to_dict()


def _filter_config(d: dict):
    """Native FilterConfig from a guts Filter/BandstopFilter/
    FrequencyFilter mapping (reference ``heart.py:342-428``)."""
    from beat_tpu_torch.config import FilterConfig

    if "freqlimits" in d:
        return FilterConfig(type="frequency",
                            freqlimits=tuple(d["freqlimits"]))
    # BandstopFilter in guts has the same fields as Filter; the reference
    # distinguishes by class tag which _GutsLoader drops — use its
    # distinctive defaults to tell them apart is impossible, so the
    # conservative read is bandpass unless the mapping says otherwise.
    kind = "bandstop" if d.get("type") == "bandstop" else "butterworth"
    return FilterConfig(lower_corner=float(d.get("lower_corner", 0.001)),
                        upper_corner=float(d.get("upper_corner", 0.1)),
                        order=int(d.get("order", 4)), type=kind)


def _waveform_fit_config(d: dict, notes: list):
    from beat_tpu_torch.config import ArrivalTaperConfig, WaveformFitConfig

    taper = d.get("arrival_taper") or {}
    filt = d.get("filterer")
    if isinstance(filt, dict):
        filt = [filt]
    filterer = [_filter_config(f) for f in (filt or [])] or None
    arrivals = d.get("arrivals_marker_path")
    if arrivals:
        notes.append(f"wavemap {d.get('name')}: arrivals_marker_path "
                     f"{arrivals!r} must be converted with "
                     "snuffler_markers_to_arrivals_csv() if present")
    wf = WaveformFitConfig(
        include=bool(d.get("include", True)),
        preprocess_data=bool(d.get("preprocess_data", True)),
        name=d.get("name", "any_P"),
        channels=list(d.get("channels", ["Z"])),
        arrival_taper=ArrivalTaperConfig(
            a=float(taper.get("a", -15.0)), b=float(taper.get("b", -10.0)),
            c=float(taper.get("c", 40.0)), d=float(taper.get("d", 55.0))),
        distances=tuple(d["distances"]) if d.get("distances") else None,
        interpolation=d.get("interpolation", "multilinear"),
        domain=d.get("domain", "time"),
        quantity=d.get("quantity", "displacement"),
        blacklist=list(d.get("blacklist", [])),
        event_idx=int(d.get("event_idx", 0) or 0),
    )
    if filterer is not None:
        wf.filterer = filterer if len(filterer) > 1 else filterer[0]
    return wf


def _sampler_params(name: str, p: dict, notes: list) -> dict:
    """Map guts SMCConfig/MetropolisConfig/ParallelTemperingConfig
    parameter mappings onto the native sampler params (reference
    ``config.py:1698-1833``).  Process-pool fields (n_jobs) have no
    native meaning — chains ride the device mesh."""
    out = {}
    common = {"n_chains": int, "n_steps": int, "tune_interval": int}
    for k, cast in common.items():
        if k in p:
            out[k] = cast(p[k])
    if "proposal_dist" in p:
        out["proposal_name"] = str(p["proposal_dist"])
    if name == "SMC":
        for k in ("coef_variation",):
            if k in p:
                out[k] = float(p[k])
        if "rm_flag" in p:
            out["rm_flag"] = bool(p["rm_flag"])
        if "stage" in p and str(p["stage"]) not in ("0", "None"):
            notes.append(f"sampler stage={p['stage']} reset to 0 (resume "
                         "state does not transfer between frameworks)")
    elif name == "Metropolis":
        if "thin" in p:
            out["thin"] = int(p["thin"])
        if "burn" in p:
            out["burn"] = float(p["burn"])
    elif name == "PT":
        for k in ("n_chains_posterior", "swap_interval", "beta_tune_interval",
                  "n_samples"):
            if k in p:
                out[k] = p[k] if isinstance(p[k], list) else int(p[k])
    dropped = sorted(set(p) - set(common) -
                     {"proposal_dist", "coef_variation", "rm_flag", "stage",
                      "thin", "burn", "n_chains_posterior", "swap_interval",
                      "beta_tune_interval", "n_samples"})
    if dropped:
        notes.append(f"{name} sampler fields without native equivalent "
                     f"dropped: {', '.join(dropped)}")
    return out


def _geodetic_config_from_guts(g: dict, notes: list):
    from beat_tpu_torch.config import (EulerPoleConfig, GeodeticConfig,
                                 GeodeticCorrectionsConfig,
                                 NoiseEstimatorConfig, RampConfig,
                                 StrainRateConfig)

    ne = g.get("noise_estimator") or {}
    cc = g.get("corrections_config") or {}
    ramp = cc.get("ramp")
    names = ["all"]
    types = []
    # reference GeodeticConfig.types: dict datatype -> dataset config
    # (SARDatasetConfig carries names; config.py:916-968)
    for typ, tconf in (g.get("types") or {}).items():
        types.append(typ)
        tnames = (tconf or {}).get("names")
        if tnames:
            names = list(tnames) if names == ["all"] else names + list(tnames)
    gc = GeodeticConfig(
        names=names,
        types=types or ["SAR", "GNSS"],
        noise_estimator=NoiseEstimatorConfig(
            structure=ne.get("structure", "import"),
            max_dist_perc=float(ne.get("max_dist_perc", 0.2))),
        interpolation=g.get("interpolation", "multilinear"),
        corrections=GeodeticCorrectionsConfig(
            ramps=RampConfig(enabled=bool(ramp.get("enabled", False)),
                             dataset_names=list(ramp.get("dataset_names", [])))
            if ramp else None,
            euler_poles=[EulerPoleConfig(
                enabled=bool(ep.get("enabled", False)),
                station_whitelist=list(ep.get("station_whitelist", [])),
                station_blacklist=list(ep.get("station_blacklist", [])),
                dataset_names=list(ep.get("dataset_names", [])))
                for ep in cc.get("euler_poles", [])],
            strain_rates=[StrainRateConfig(
                enabled=bool(sr.get("enabled", False)),
                station_whitelist=list(sr.get("station_whitelist", [])),
                station_blacklist=list(sr.get("station_blacklist", [])),
                dataset_names=list(sr.get("dataset_names", [])))
                for sr in cc.get("strain_rates", [])]),
        dataset_specific_residual_noise_estimation=bool(
            g.get("dataset_specific_residual_noise_estimation", False)),
    )
    gf = g.get("gf_config") or {}
    native_gf = {}
    if gf.get("n_variations"):
        nv = gf["n_variations"]
        native_gf["n_variations"] = int(nv[1] - nv[0]) if isinstance(nv, list) else int(nv)
    native_gf["reference_earth_model"] = gf.get("earth_model_name", "")
    gc.gf_config = native_gf
    return gc


def beat_config_from_guts(path: str):
    """
    Convert a reference-BEAT guts-YAML config file into a native
    :class:`beat_tpu_torch.config.BEATconfig`.

    Returns ``(config, notes)`` where ``notes`` lists every reference
    field that has no native equivalent (nothing is silently dropped).
    Data paths inside the config are re-pointed at the project dir —
    data import is a separate step (:func:`import_beat_project`).
    """
    from beat_tpu_torch.config import (BEATconfig, EventConfig, NoiseEstimatorConfig,
                                 PolarityConfig, PolarityFitConfig,
                                 ProblemConfig, SamplerConfig, SeismicConfig)

    d = load_guts_yaml(path)
    notes: list[str] = []

    ev = d.get("event") or {}
    event = EventConfig(
        name=str(ev.get("name", d.get("name", "event"))),
        lat=float(ev.get("lat", 0.0)), lon=float(ev.get("lon", 0.0)),
        depth=float(ev.get("depth", 10e3)),
        time=guts_time_to_epoch(ev.get("time", 0.0)),
        magnitude=float(ev.get("magnitude", 6.0)),
        duration=float(ev["duration"]) if ev.get("duration") is not None else None,
        moment_tensor={k: float(v) for k, v in (ev.get("moment_tensor") or {}).items()},
    )

    p = d.get("problem_config") or {}
    pc = ProblemConfig(
        mode=p.get("mode", "geometry"),
        source_types=list(p.get("source_types", ["RectangularSource"])),
        n_sources=[int(n) for n in p.get("n_sources", [1])],
        datatypes=list(p.get("datatypes", [])),
        stf_type=p.get("stf_type", "HalfSinusoid"),
        decimation_factors={k: int(v) for k, v in
                            (p.get("decimation_factors") or {}).items()},
        priors={name: _param_dict(pd)
                for name, pd in (p.get("priors") or {}).items()},
        hyperparameters={name: _param_dict(pd)
                         for name, pd in (p.get("hyperparameters") or {}).items()},
    )

    config = BEATconfig(name=str(d.get("name", "imported")),
                        date=str(d.get("date", "")),
                        event=event, problem_config=pc)

    s = d.get("seismic_config")
    if s:
        ne = s.get("noise_estimator") or {}
        config.seismic_config = SeismicConfig(
            noise_estimator=NoiseEstimatorConfig(
                structure=ne.get("structure", "variance"),
                pre_arrival_time=float(ne.get("pre_arrival_time", 5.0))),
            station_corrections=bool(s.get("station_corrections", False)),
            pre_stack_cut=bool(s.get("pre_stack_cut", True)),
            waveforms=[_waveform_fit_config(w, notes)
                       for w in s.get("waveforms", [])],
            dataset_specific_residual_noise_estimation=bool(
                s.get("dataset_specific_residual_noise_estimation", False)),
        )
        gf = s.get("gf_config") or {}
        native_gf = {}
        if gf.get("sample_rate"):
            native_gf["dt"] = 1.0 / float(gf["sample_rate"])
        if gf.get("n_variations"):
            nv = gf["n_variations"]
            native_gf["n_variations"] = (int(nv[1] - nv[0])
                                         if isinstance(nv, list) else int(nv))
        native_gf["reference_earth_model"] = gf.get("earth_model_name", "")
        if gf.get("custom_velocity_model"):
            # written to <project>/velocity_model.nd by import_beat_project
            native_gf["earth_model"] = "velocity_model.nd"
        config.seismic_config.gf_config = native_gf

    g = d.get("geodetic_config")
    if g:
        config.geodetic_config = _geodetic_config_from_guts(g, notes)

    pol = d.get("polarity_config")
    if pol:
        maps = pol.get("waveforms") or []
        config.polarity_config = PolarityConfig(waveforms=[
            PolarityFitConfig(
                name=m.get("name", "any_P"),
                include=bool(m.get("include", True)),
                blacklist=list(m.get("blacklist", [])),
                event_idx=int(m.get("event_idx", 0) or 0))
            for m in maps])
        gf = pol.get("gf_config") or {}
        native_gf = {"reference_earth_model": gf.get("earth_model_name", "")}
        if gf.get("custom_velocity_model"):
            native_gf["earth_model"] = "velocity_model.nd"
        config.polarity_config.gf_config = native_gf
        for m in maps:
            if m.get("polarities_marker_path"):
                notes.append(
                    f"polarity map {m.get('name')}: marker file "
                    f"{m['polarities_marker_path']!r} — import with "
                    "polarity_targets_from_markers()")

    for key in ("sampler_config", "hyper_sampler_config"):
        sd = d.get(key)
        if not sd:
            continue
        sc = SamplerConfig(
            name=sd.get("name", "SMC"),
            buffer_thinning=int(sd.get("buffer_thinning", 1)),
            parameters=_sampler_params(sd.get("name", "SMC"),
                                       sd.get("parameters") or {}, notes))
        if sd.get("backend") and sd["backend"] not in ("npz",):
            notes.append(f"{key}.backend {sd['backend']!r} -> native "
                         "npz stage backend")
            sc.backend = "npz"
        setattr(config, key, sc)

    # velocity model payloads for import_beat_project to persist
    config._custom_velocity_models = {
        dt: (d.get(f"{dt2}_config") or {}).get("gf_config", {}).get(
            "custom_velocity_model")
        for dt, dt2 in (("seismic", "seismic"), ("polarity", "polarity"))
        if d.get(f"{dt2}_config")}

    return config, notes


# ---------------------------------------------------------------------------
# pyrocko pickle shim
# ---------------------------------------------------------------------------


class _AttrBag:
    """Stand-in for any unavailable class in a pickle: records
    constructor kwargs and ``__setstate__`` payloads as attributes."""

    def __init__(self, *args, **kwargs):
        if args:
            self._args = args
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif (isinstance(state, tuple) and len(state) == 2
              and isinstance(state[1], dict)):
            if isinstance(state[0], dict):
                self.__dict__.update(state[0])
            self.__dict__.update(state[1])
        else:
            self._state = state

    def __call__(self, *args, **kwargs):  # callables inside cloudpickle blobs
        return _AttrBag()

    def __repr__(self):
        return f"<{type(self).__module__}.{type(self).__name__} shim>"


def _cloudpickle_builtin_type(name):
    return getattr(_types, name, _AttrBag)


class ShimUnpickler(pickle.Unpickler):
    """Unpickler materialising attribute bags for pyrocko/beat/pytensor
    class names so the numpy payloads inside reference pickles can be
    read without those packages installed."""

    _REAL = ("numpy", "builtins", "collections", "datetime", "copyreg")

    def find_class(self, module, name):
        if module.split(".")[0] in self._REAL:
            return super().find_class(module, name)
        if name == "_builtin_type":        # cloudpickle type marker
            return _cloudpickle_builtin_type
        if "." in name:                    # method refs (TensorType.filter)
            return lambda *a, **k: None
        return type(name, (_AttrBag,), {"__module__": module})


def load_pyrocko_pickle(path: str):
    with open(path, "rb") as f:
        return ShimUnpickler(f).load()


def seismic_arrays_from_pickle(path: str):
    """
    Decode a reference ``seismic_data.pkl`` (``[stations, data_traces]``,
    reference ``models/seismic.py:94`` + ``utility.load_objects``).

    Returns ``(stations, traces)``:

    * stations: list of dicts ``{name ('NET.STA'), lat, lon, elevation,
      depth, channels: {name: (azimuth, dip)}}``
    * traces: list of dicts ``{network, station, location, channel,
      tmin (epoch), deltat, ydata}`` — from the 12-tuple
      ``SeismicDataset.__getstate__`` (reference ``heart.py:931-944``:
      network, station, location, channel, tmin, tmax, deltat, mtime,
      ydata, meta, wavename, covariance).
    """
    payload = load_pyrocko_pickle(path)
    if not (isinstance(payload, (list, tuple)) and len(payload) == 2):
        raise ValueError(f"{path}: expected [stations, traces], got "
                         f"{type(payload).__name__}")
    raw_stations, raw_traces = payload

    stations = []
    for s in raw_stations:
        chans = {}
        for ch in getattr(s, "channels", None) or []:
            chans[str(ch.name)] = (
                float(ch.azimuth) if getattr(ch, "azimuth", None) is not None else None,
                float(ch.dip) if getattr(ch, "dip", None) is not None else None)
        stations.append(dict(
            name=f"{s.network}.{s.station}",
            network=str(s.network), station=str(s.station),
            location=str(getattr(s, "location", "") or ""),
            lat=float(s.lat), lon=float(s.lon),
            elevation=float(getattr(s, "elevation", 0.0) or 0.0),
            depth=float(getattr(s, "depth", 0.0) or 0.0),
            channels=chans))

    traces = []
    for t in raw_traces:
        st = getattr(t, "_state", None)
        if st is None or len(st) < 9:
            raise ValueError(f"{path}: trace state tuple not recognised "
                             f"({type(t).__name__})")
        traces.append(dict(
            network=str(st[0]), station=str(st[1]), location=str(st[2]),
            channel=str(st[3]), tmin=float(st[4]), deltat=float(st[6]),
            ydata=np.asarray(st[8], dtype=np.float64)))
    return stations, traces


def geodetic_datasets_from_pickle(path: str, event=None) -> list:
    """
    Decode a reference ``geodetic_data.pkl`` (list of DiffIFG /
    GNSSCompoundComponent guts objects, reference
    ``models/geodetic.py:80``) into native
    :class:`~beat_tpu_torch.heart.geodesy.GeodeticDataset` objects —
    including the quadtree polygon ``mask`` (reference
    ``DiffIFG.mask`` / ``get_data_mask`` ``heart.py:1434,1520``) and the
    imported covariance.  ``event`` (anything with lat/lon) projects
    leaf lats/lons to local coordinates.
    """
    from beat_tpu_torch.covariance import Covariance
    from beat_tpu_torch.heart.geodesy import diff_ifg, gnss_compound

    payload = load_pyrocko_pickle(path)
    if not isinstance(payload, (list, tuple)):
        payload = [payload]
    datasets = []
    for obj in payload:
        kind = type(obj).__name__
        cov = getattr(obj, "covariance", None)
        cov_data = np.asarray(cov.data, dtype=np.float64) \
            if cov is not None and getattr(cov, "data", None) is not None else None
        if kind in ("DiffIFG", "IFG"):
            lats = np.asarray(obj.lats, dtype=np.float64)
            lons = np.asarray(obj.lons, dtype=np.float64)
            ds = diff_ifg(str(obj.name), np.zeros((lats.size, 2)),
                          np.asarray(obj.displacement, dtype=np.float64),
                          incidence=np.asarray(obj.incidence, dtype=np.float64),
                          heading=np.asarray(obj.heading, dtype=np.float64))
            ds.lats, ds.lons = lats, lons
            odw = getattr(obj, "odw", None)
            if odw is not None:
                ds.odw = np.asarray(odw, dtype=np.float64)
            mask = getattr(obj, "mask", None)
            if mask is not None:
                ds.mask = np.asarray(mask, dtype=bool)
        elif kind == "GNSSCompoundComponent":
            comp = str(obj.component)
            comp = {"E": "east", "N": "north", "U": "up"}.get(comp, comp)
            stas = getattr(obj, "stations", None) or []
            lats = np.asarray([s.lat for s in stas], dtype=np.float64)
            lons = np.asarray([s.lon for s in stas], dtype=np.float64)
            disp = np.asarray([getattr(s, comp).shift for s in stas],
                              dtype=np.float64)
            ds = gnss_compound(f"gnss_{comp}", np.zeros((lats.size, 2)),
                               disp, comp)
            ds.lats, ds.lons = lats, lons
            ds.stations = np.asarray(
                [f"{s.network}.{s.station}".strip(".") for s in stas])
        else:
            logger.warning("geodetic pickle %s: unsupported dataset class "
                           "%s skipped", path, kind)
            continue
        if cov_data is not None:
            ds.covariance = Covariance(data=cov_data)
        if event is not None:
            ds.update_local_coords(float(event.lat), float(event.lon))
        datasets.append(ds)
    return datasets


# ---------------------------------------------------------------------------
# pyrocko text formats (stations + snuffler markers)
# ---------------------------------------------------------------------------


def load_pyrocko_stations(path: str) -> list:
    """
    Parse a pyrocko "basic station file": per station a header line
    ``NET.STA.LOC  lat lon elevation depth`` followed by channel lines
    ``NAME azimuth dip gain`` (reference reads these with
    ``pyrocko.model.load_stations``, ``apps/beat.py`` import paths).
    """
    stations = []
    with open(path) as f:
        for line in f:
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            parts = line.split()
            indented = line[:1].isspace()
            if not indented and "." in parts[0] and len(parts) >= 3:
                nsl = parts[0].split(".")
                net, sta = nsl[0], nsl[1]
                loc = nsl[2] if len(nsl) > 2 else ""
                stations.append(dict(
                    name=f"{net}.{sta}", network=net, station=sta,
                    location=loc,
                    lat=float(parts[1]), lon=float(parts[2]),
                    elevation=float(parts[3]) if len(parts) > 3 else 0.0,
                    depth=float(parts[4]) if len(parts) > 4 else 0.0,
                    channels={}))
            elif stations and len(parts) >= 3:
                try:
                    az, dip = float(parts[1]), float(parts[2])
                except ValueError:
                    continue
                stations[-1]["channels"][parts[0]] = (az, dip)
    if not stations:
        raise ValueError(f"{path}: no stations parsed")
    return stations


def load_snuffler_markers(path: str) -> list:
    """
    Parse snuffler *phase* markers (``# Snuffler Markers File Version
    0.2``): per line ``phase: <date> <time> <kind> <NET.STA.LOC.CHA>
    <event_hash> <event_date> <event_time> <phasename> <polarity>
    <automatic>`` — the polarity column carries the picked first motion
    (reference ``PolarityMapping`` consumes these via pyrocko.gui.marker).
    """
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or not line.startswith("phase:"):
                continue
            parts = line.split()
            # point form:
            #   phase: date time kind nslc hash evdate evtime phase pol auto
            # span form (tmin != tmax) inserts a second date/time pair
            # plus a duration column after the first time:
            #   phase: date time date2 time2 dur kind nslc hash ...
            # — so the event/phase/polarity columns are parsed from the
            # END of the line, which is identical in both forms
            if len(parts) < 10:
                continue
            span = "-" in parts[3] and ":" not in parts[3]
            if span and len(parts) < 13:
                continue
            nslc = parts[-7].split(".")
            net, sta = nslc[0], nslc[1]
            try:
                polarity = int(parts[-2])
            except ValueError:
                polarity = 0
            out.append(dict(
                station=f"{net}.{sta}",
                channel=nslc[3] if len(nslc) > 3 else "",
                time=guts_time_to_epoch(parts[1] + " " + parts[2]),
                event_time=guts_time_to_epoch(parts[-5] + " " + parts[-4]),
                phase=parts[-3], polarity=polarity))
    if not out:
        raise ValueError(f"{path}: no phase markers parsed")
    return out


def snuffler_markers_to_arrivals_csv(markers_path: str, out_path: str,
                                     event_time: float | None = None) -> str:
    """Convert snuffler phase markers into the native picked-arrivals
    CSV (``station,time_s`` after origin; ``inputf.load_arrivals_csv``)."""
    markers = load_snuffler_markers(markers_path)
    with open(out_path, "w") as f:
        f.write("station,time_s\n")
        for m in markers:
            t0 = event_time if event_time is not None else m["event_time"]
            f.write(f"{m['station']},{m['time'] - t0:.4f}\n")
    return out_path


def polarity_targets_from_markers(markers_path: str, stations_path: str,
                                  event) -> list:
    """
    First-motion targets from real snuffler markers + a pyrocko station
    file (the MTQT_polarity example inputs): azimuth/distance from the
    event-station geometry; takeoff angles are left to the project's
    ray-traced tables at load time (``load_polarity_targets`` with
    ``distances_m``).
    """
    from beat_tpu_torch.heart.geodesy import local_offset
    from beat_tpu_torch.heart.polarity import PolarityTarget

    stations = {s["name"]: s for s in load_pyrocko_stations(stations_path)}
    targets = []
    missing = []
    for m in load_snuffler_markers(markers_path):
        if m["polarity"] == 0:
            continue
        st = stations.get(m["station"])
        if st is None:
            missing.append(m["station"])
            continue
        e, n = local_offset(float(event.lat), float(event.lon),
                            st["lat"], st["lon"])
        targets.append(PolarityTarget(
            station=m["station"], azimuth_rad=float(np.arctan2(e, n)),
            takeoff_rad=np.pi,        # placeholder; ray-traced at load
            polarity=int(np.sign(m["polarity"])),
            distance_m=float(np.hypot(e, n))))
    if missing:
        logger.warning("polarity markers reference stations missing from "
                       "%s: %s", stations_path, ", ".join(sorted(set(missing))))
    if not targets:
        raise ValueError("no polarity targets with nonzero first motions")
    return targets


# ---------------------------------------------------------------------------
# raw (pre-gridding) seismic persistence
# ---------------------------------------------------------------------------


def save_raw_seismic(stations: list, traces: list, project_dir: str,
                     event=None) -> str:
    """Persist imported traces before GF-table gridding:
    ``seismic_data_raw.npz`` holds per-trace metadata + samples and the
    station table (with local coordinates when ``event`` is given)."""
    from beat_tpu_torch.heart.geodesy import local_offset

    arrays = {}
    meta_sta, meta_net, meta_loc, meta_cha = [], [], [], []
    meta_tmin, meta_dt = [], []
    for i, tr in enumerate(traces):
        arrays[f"tr{i}:ydata"] = tr["ydata"]
        meta_net.append(tr["network"])
        meta_sta.append(tr["station"])
        meta_loc.append(tr["location"])
        meta_cha.append(tr["channel"])
        meta_tmin.append(tr["tmin"])
        meta_dt.append(tr["deltat"])
    arrays["tr_network"] = np.asarray(meta_net)
    arrays["tr_station"] = np.asarray(meta_sta)
    arrays["tr_location"] = np.asarray(meta_loc)
    arrays["tr_channel"] = np.asarray(meta_cha)
    arrays["tr_tmin"] = np.asarray(meta_tmin, dtype=np.float64)
    arrays["tr_deltat"] = np.asarray(meta_dt, dtype=np.float64)

    arrays["st_name"] = np.asarray([s["name"] for s in stations])
    arrays["st_station"] = np.asarray([s["station"] for s in stations])
    arrays["st_lat"] = np.asarray([s["lat"] for s in stations])
    arrays["st_lon"] = np.asarray([s["lon"] for s in stations])
    if event is not None:
        en = [local_offset(float(event.lat), float(event.lon),
                           s["lat"], s["lon"]) for s in stations]
        arrays["st_east"] = np.asarray([x[0] for x in en])
        arrays["st_north"] = np.asarray([x[1] for x in en])
    path = os.path.join(project_dir, "seismic_data_raw.npz")
    os.makedirs(project_dir, exist_ok=True)
    np.savez_compressed(path, **arrays)
    return path


def load_raw_seismic(project_dir: str):
    """Inverse of :func:`save_raw_seismic` -> (stations, traces)."""
    path = os.path.join(project_dir, "seismic_data_raw.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"No raw seismic data at {path}")
    stations, traces = [], []
    with np.load(path, allow_pickle=False) as z:
        n_tr = z["tr_tmin"].size
        for i in range(n_tr):
            traces.append(dict(
                network=str(z["tr_network"][i]), station=str(z["tr_station"][i]),
                location=str(z["tr_location"][i]), channel=str(z["tr_channel"][i]),
                tmin=float(z["tr_tmin"][i]), deltat=float(z["tr_deltat"][i]),
                ydata=z[f"tr{i}:ydata"]))
        for j in range(z["st_name"].size):
            stations.append(dict(
                name=str(z["st_name"][j]), station=str(z["st_station"][j]),
                lat=float(z["st_lat"][j]), lon=float(z["st_lon"][j]),
                east=float(z["st_east"][j]) if "st_east" in z.files else None,
                north=float(z["st_north"][j]) if "st_north" in z.files else None))
    return stations, traces


def prepare_imported_seismic(project_dir: str, datadir: str = "./", *, device="cuda") -> list:
    """Grid the raw imported traces onto the project's GF table
    (requires ``gf_table.npz``; run ``beat-tpu build_gfs --mode geometry``
    first), the table read onto ``device``.  Produces the native
    ``seismic_data.npz``."""
    from beat_tpu_torch.apps.beatdown import prepare_local_traces
    from beat_tpu_torch.config import load_config
    from beat_tpu_torch.heart.gftable import GreensTable

    table_path = os.path.join(project_dir, "gf_table.npz")
    if not os.path.exists(table_path):
        raise FileNotFoundError(
            f"No GF table at {table_path} — run "
            "'beat-tpu build_gfs <project> --mode geometry' first")
    table = GreensTable.load(table_path, device=device)
    config = load_config(project_dir)
    stations, traces = load_raw_seismic(project_dir)
    st_by_name = {s["station"]: s for s in stations}
    tr_map, coords = {}, {}
    for tr in traces:
        st = st_by_name.get(tr["station"])
        if st is None or st.get("east") is None:
            logger.warning("trace %s.%s: no station coordinates — skipped",
                           tr["station"], tr["channel"])
            continue
        tr_map.setdefault(tr["station"], {})[tr["channel"]] = (
            tr["tmin"], tr["deltat"], tr["ydata"])
        coords[tr["station"]] = (st["east"], st["north"])
    return prepare_local_traces(tr_map, coords, {"time": config.event.time},
                                table, project_dir, datadir)


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------


def _seismic_gf_grid(config, stations, gf: dict) -> dict:
    """Native table-grid parameters for an imported seismic project:
    distance extent from the actual stations (padded by the location
    priors), depth extent from the depth prior, dt from the reference
    store sample rate, nt covering the last arrival window."""
    from beat_tpu_torch.heart.geodesy import local_offset

    pr = config.problem_config.priors

    def span(name, default):
        if name in pr:
            p = pr[name]
            return float(np.min(p["lower"])) * 1e3, float(np.max(p["upper"])) * 1e3
        return default

    dists = []
    for s in stations:
        e, n = local_offset(config.event.lat, config.event.lon,
                            s["lat"], s["lon"])
        dists.append(np.hypot(e, n))
    dists = np.asarray(dists)
    shift = max(abs(v) for name in ("east_shift", "north_shift")
                for v in span(name, (0.0, 0.0)))
    pad = np.sqrt(2.0) * shift + 5e3
    d_lo = max(float(dists.min()) - pad, 1e3)
    d_hi = float(dists.max()) + pad
    z_lo, z_hi = span("depth", (config.event.depth, config.event.depth))
    z_lo, z_hi = max(z_lo, 500.0), max(z_hi, z_lo + 1e3)

    dt = float(gf.get("dt", 0.5))
    # last fit-window end: slowest configured phase's arrival + taper
    # tail + margin.  S-phase wavemaps arrive at ~d/3500, not ~d/5500 —
    # sizing the axis for P only would let far-edge S fit windows run
    # past the table end, where the window clipping silently
    # mis-positions them (advisor round-4 finding)
    def _is_s_phase(name: str) -> bool:
        # any_S / any_SH / any_SV / S / slowest — anything not clearly P
        tail = (name or "").lower().split("_")[-1]
        return "s" in tail and "p" not in tail

    wfcs = config.seismic_config.waveforms
    taper_d = max(w.arrival_taper.d for w in wfcs) if wfcs else 60.0
    v_slowest = 3000.0 if any(_is_s_phase(w.name) for w in wfcs) else 5500.0
    t_end = d_hi / v_slowest + taper_d + 40.0
    nt = int(2 ** np.ceil(np.log2(max(t_end / dt, 64))))

    spacing = float(gf.get("distance_spacing", 4e3))
    n_d = int(np.clip(np.ceil((d_hi - d_lo) / spacing) + 1, 8, 320))
    n_z = int(np.clip(np.ceil((z_hi - z_lo) / 1e3) + 1, 4, 32))
    out = dict(distance_min=float(d_lo), distance_max=float(d_hi),
               n_distances=int(n_d), depth_min=float(z_lo),
               depth_max=float(z_hi), n_depths=int(n_z),
               nt=int(nt), dt=float(dt), t0=0.0)
    # synthesis band: no energy needed above the highest filter corner
    corners = []
    for w in config.seismic_config.waveforms:
        fl = w.filterer if isinstance(w.filterer, (list, tuple)) else [w.filterer]
        for fc in fl:
            if getattr(fc, "type", "butterworth") == "butterworth":
                corners.append(float(fc.upper_corner))
            elif getattr(fc, "freqlimits", None):
                corners.append(float(fc.freqlimits[2]))
    if corners:
        out["fmax"] = 2.0 * max(corners)
    return out


def import_beat_project(src_dir: str, dest_dir: str,
                        gf_overrides: dict | None = None,
                        build: bool = True, *, device="cuda") -> tuple:
    """
    One-shot migration of a reference-BEAT project directory: parse the
    guts config, decode the data pickles / marker files, write the
    native project (config + data + velocity model), optionally build
    the GF tables on ``device`` and grid the traces.

    Returns ``(config, notes)``.

    The reference's own integration tests load exactly these project
    layouts (``test/test_composites.py:32-36``).
    """
    from beat_tpu_torch.config import (dump_config, save_geodetic_datasets,
                                 save_polarity_targets)

    cfg_path = os.path.join(src_dir, "config_geometry.yaml")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(f"No config_geometry.yaml in {src_dir}")
    config, notes = beat_config_from_guts(cfg_path)
    config.project_dir = dest_dir
    os.makedirs(dest_dir, exist_ok=True)

    # velocity model from the embedded custom model (qseis/cake input).
    # A non-'local' base earth model continues BELOW the custom crust
    # (reference ``utility.py:1223`` join_models) and, being spherical,
    # requires the earth-flattening transform at table-build time.
    # ``gf_overrides={'join_base_model': False}`` keeps the custom model
    # alone — the bundled FullMT example's synthetic waveforms were
    # generated against a store WITHOUT the ak135 continuation (the
    # plain custom model fits them decisively better; see
    # tests/test_fullmt_real.py), so the flagship pipeline disables the
    # join while real projects keep reference semantics by default.
    gf_overrides = dict(gf_overrides or {})
    join_base = gf_overrides.pop("join_base_model", True)
    custom_models = getattr(config, "_custom_velocity_models", {})
    wrote_model = False
    for dt_name, text in custom_models.items():
        if text:
            gf_cfg = getattr(getattr(config, f"{dt_name}_config", None),
                             "gf_config", None) or {}
            base = gf_cfg.get("reference_earth_model", "")
            if join_base and base and base != "local":
                from beat_tpu_torch.heart.velocity_model import join_nd_with_ak135

                text = join_nd_with_ak135(text)
                if config.seismic_config is not None:
                    config.seismic_config.gf_config["earth_flattening"] = True
            with open(os.path.join(dest_dir, "velocity_model.nd"), "w") as f:
                f.write(text)
            wrote_model = True
            break
    if not wrote_model:
        # gf_config names only a global base model (no custom crust):
        # honor it — the reference builds its stores from that model
        # (``get_velocity_model`` heart.py:1902), so silently falling
        # back to the homogeneous default would change the physics
        unhonored = []
        for dt_name in ("seismic", "geodetic", "polarity"):
            dt_cfg = getattr(config, f"{dt_name}_config", None)
            gf_cfg = getattr(dt_cfg, "gf_config", None)
            if not gf_cfg or gf_cfg.get("earth_model"):
                continue
            base = gf_cfg.get("reference_earth_model", "")
            if not base or base == "local":
                continue
            if base.lower().startswith("ak135"):
                from beat_tpu_torch.heart.velocity_model import ak135_f_average_nd_text

                with open(os.path.join(dest_dir, "velocity_model.nd"),
                          "w") as f:
                    f.write(ak135_f_average_nd_text())
                for other in ("seismic", "geodetic", "polarity"):
                    c2 = getattr(config, f"{other}_config", None)
                    g2 = getattr(c2, "gf_config", None)
                    if g2 is not None and g2.get(
                            "reference_earth_model", "").lower().startswith(
                            "ak135"):
                        g2["earth_model"] = "velocity_model.nd"
                        if other == "seismic":
                            # spherical base model → flatten before DWN
                            g2["earth_flattening"] = True
                note = (f"base earth model {base!r}: using the embedded "
                        "ak135-f-average (earth-flattened for waveform "
                        "builds)")
                if "average" not in base.lower():
                    note += (" — the reference's regional crust variant "
                             "differs slightly in the upper layers")
                notes.append(note)
                wrote_model = True
                break
            unhonored.append((dt_name, base))
        if not wrote_model and unhonored:
            msg = ", ".join(f"{dt}: {b!r}" for dt, b in unhonored)
            if build:
                raise ValueError(
                    f"cannot honor the project's base earth model ({msg}) "
                    "natively — known global models: ak135*, 'local'. "
                    "Import with build=False and supply "
                    "<project>/velocity_model.nd yourself, or set "
                    "gf_overrides={'earth_model': ...}")
            notes.append(f"base earth model not honored ({msg}) — GF "
                         "builds would use the homogeneous default; "
                         "supply velocity_model.nd before build_gfs")

    datatypes = set(config.problem_config.datatypes)

    if "seismic" in datatypes and config.seismic_config is not None:
        pkl = os.path.join(src_dir, "seismic_data.pkl")
        if os.path.exists(pkl):
            stations, traces = seismic_arrays_from_pickle(pkl)
            save_raw_seismic(stations, traces, dest_dir, event=config.event)
            grid = _seismic_gf_grid(config, stations, config.seismic_config.gf_config)
            grid.update(config.seismic_config.gf_config)
            grid.update(gf_overrides or {})
            config.seismic_config.gf_config = grid
            logger.info("seismic: %i stations, %i traces; native table "
                        "grid %s", len(stations), len(traces),
                        {k: grid[k] for k in ("n_distances", "n_depths",
                                              "nt", "dt")})
        else:
            notes.append(f"seismic datatype configured but no "
                         f"seismic_data.pkl in {src_dir}")
            datatypes.discard("seismic")

    if "geodetic" in datatypes and config.geodetic_config is not None:
        pkl = os.path.join(src_dir, "geodetic_data.pkl")
        if os.path.exists(pkl):
            datasets = geodetic_datasets_from_pickle(pkl, event=config.event)
            save_geodetic_datasets(datasets, dest_dir)
            logger.info("geodetic: %i datasets, %i observations",
                        len(datasets), sum(d.samples for d in datasets))
        else:
            notes.append(f"geodetic datatype configured but no "
                         f"geodetic_data.pkl in {src_dir}")
            datatypes.discard("geodetic")

    if "polarity" in datatypes and config.polarity_config is not None:
        found = False
        for pmap in config.polarity_config.waveforms:
            for cand in (f"polarity_markers_{pmap.name.split('_')[-1]}.pf",
                         "polarity_markers_P.pf"):
                markers = os.path.join(src_dir, cand)
                if os.path.exists(markers):
                    break
            stations_path = os.path.join(src_dir, "stations.txt")
            if os.path.exists(markers) and os.path.exists(stations_path):
                targets = polarity_targets_from_markers(
                    markers, stations_path, config.event)
                fname = (f"polarity_data_{pmap.name}.npz"
                         if len(config.polarity_config.waveforms) > 1
                         else "polarity_data.npz")
                save_polarity_targets(targets, dest_dir)
                if fname != "polarity_data.npz":
                    os.replace(os.path.join(dest_dir, "polarity_data.npz"),
                               os.path.join(dest_dir, fname))
                    pmap.polarities_path = fname
                found = True
                logger.info("polarity map %s: %i targets", pmap.name,
                            len(targets))
        if not found:
            notes.append(f"polarity datatype configured but no marker/"
                         f"station files found in {src_dir}")
            datatypes.discard("polarity")

    config.problem_config.datatypes = sorted(datatypes)
    if hasattr(config, "_custom_velocity_models"):
        del config._custom_velocity_models   # not a config field
    dump_config(config, dest_dir)

    if build and "seismic" in datatypes:
        import argparse

        from beat_tpu_torch.apps.commands import _cmd_build_gfs

        args = argparse.Namespace(project_dir=dest_dir, mode="geometry",
                                  datatypes="seismic", earth_model=None,
                                  seismic_tracestore=None,
                                  patch_length=2.0, patch_width=2.0,
                                  nt=512, dt=0.5, t0=0.0, device=device)
        _cmd_build_gfs(args)
        prepare_imported_seismic(dest_dir, device=device)

    for note in notes:
        logger.warning("import note: %s", note)
    return config, notes
