"""
``beat-tpu-torch-down`` — waveform data acquisition and preparation
(copied from ``beat_tpu/apps/beatdown.py``; the reference ``beatdown``
app, ``beat/apps/beatdown.py``):
FDSN event/waveform mass download, station weeding, restitution to
displacement, rotation to RTZ, and persistence into the project's native
seismic dataset format.

Network access and obspy/pyrocko are environment-dependent, so every
stage is import-gated; the local-file preparation path
(:func:`prepare_local_traces`) is always available and is what the
hermetic pipeline uses.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

logger = logging.getLogger("beat_tpu_torch.beatdown")


def get_events(time_range, magmin=5.5, catalog="IRIS"):
    """Query an FDSN event catalog (reference ``beatdown.get_events``
    :80, there via pyrocko GCMT; here via obspy FDSN — gated).

    time_range : (start, end) UTC strings or epoch floats.
    Returns a list of dicts with time/lat/lon/depth/magnitude.
    """
    try:
        from obspy import UTCDateTime
        from obspy.clients.fdsn import Client
    except ImportError as e:
        raise ImportError("obspy is required for catalog queries") from e
    client = Client(catalog)
    cat = client.get_events(starttime=UTCDateTime(time_range[0]),
                            endtime=UTCDateTime(time_range[1]),
                            minmagnitude=magmin)
    out = []
    for ev in cat:
        o = ev.preferred_origin() or ev.origins[0]
        m = ev.preferred_magnitude() or ev.magnitudes[0]
        out.append({"time": float(o.time.timestamp), "lat": o.latitude,
                    "lon": o.longitude, "depth": o.depth,
                    "magnitude": m.mag})
    return out


#: Known-event shorthand names (reference ``beatdown.py:112-117``).
EVENT_ALIASES = {
    "2010_haiti": "2010-01-12 21:53:00",
    "2012_emilia": ("2012-05-20 02:03:52", "2012-05-29 07:00:03"),
    "2009_laquila": "2009-04-06 01:32:39",
    "muji": "2016-11-25 14:24:30.000",
}


def _to_epoch(stime: str) -> float:
    import datetime as _dt

    s = stime.strip().replace("T", " ")
    for fmt in ("%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d"):
        try:
            return _dt.datetime.strptime(s, fmt).replace(
                tzinfo=_dt.timezone.utc).timestamp()
        except ValueError:
            continue
    raise ValueError(f"unparseable event time {stime!r}")


def get_events_by_name_or_date(event_names_or_dates, catalog="IRIS",
                               time_tol=60.0,
                               fallback_catalogs=("USGS", "ISC"),
                               events_fn=None):
    """
    Resolve events from shorthand names, date strings, or catalog files
    (reference ``get_events_by_name_or_date`` ``beatdown.py:120-158``):
    aliases expand to dates; an existing file path loads a JSON event
    catalog (list of event dicts); a date queries ``catalog`` for the
    nearest event within ``±time_tol`` seconds, falling back through
    ``fallback_catalogs`` when nothing is found.

    events_fn : override of :func:`get_events` (injection point for
        offline tests; signature ``(time_range, magmin, catalog)``).
    """
    import json
    import os

    events_fn = events_fn or get_events
    stimes = []
    for sev in event_names_or_dates:
        alias = EVENT_ALIASES.get(sev)
        if alias is None:
            stimes.append(sev)
        elif isinstance(alias, str):
            stimes.append(alias)
        else:
            stimes.extend(alias)

    events_out = []
    for stime in stimes:
        if os.path.isfile(stime):
            with open(stime) as f:
                events_out.extend(json.load(f))
            continue
        t = _to_epoch(stime)
        event = None
        for cat in (catalog,) + tuple(fallback_catalogs):
            try:
                events = events_fn((t - time_tol, t + time_tol), 0.0, cat)
            except Exception as e:   # site down / not reachable
                logger.info("catalog %s query failed: %s", cat, e)
                continue
            if events:
                event = min(events, key=lambda ev: abs(ev["time"] - t))
                break
            logger.info("Nothing found in %s! Trying others!", cat)
        if event is None:
            raise LookupError(f"no event within ±{time_tol}s of {stime!r} "
                              f"in any of {(catalog,) + tuple(fallback_catalogs)}")
        events_out.append(event)
    return events_out


class NoArrival(Exception):
    """No ray of the requested phase reaches this distance."""


class PhaseWindow:
    """Absolute cut window around a model-predicted phase arrival
    (reference ``beatdown.py:163-177``, there via cake rays; here via
    the native layered first-arrival solver).

    model : :class:`beat_tpu_torch.heart.velocity_model.LayeredModel`
    phase : 'p' or 's'; omin/omax : window offsets around the arrival [s].
    """

    def __init__(self, model, phase="p", omin=-60.0, omax=600.0):
        self.model = model
        self.phase = phase
        self.omin = omin
        self.omax = omax

    def __call__(self, time, distance, depth):
        from beat_tpu_torch.heart.velocity_model import first_arrival

        try:
            t_arr = first_arrival(self.model, max(float(depth), 1.0),
                                  float(distance), self.phase)[0]
        except Exception as e:
            raise NoArrival(
                f"no {self.phase} arrival at distance {distance}") from e
        return time + t_arr + self.omin, time + t_arr + self.omax


class VelocityWindow:
    """Group-velocity cut window (reference ``beatdown.py:179-192``):
    ``[ (depth+dist)/vmax − tpad, (depth+dist)/vmin + tpad ]`` after the
    event time; ``vmax=None`` starts the window at the origin."""

    def __init__(self, vmin, vmax=None, tpad=0.0):
        self.vmin = vmin
        self.vmax = vmax
        self.tpad = tpad

    def __call__(self, time, distance, depth):
        ttmax = (depth + distance) / self.vmin
        ttmin = (depth + distance) / self.vmax if self.vmax else 0.0
        return time + ttmin - self.tpad, time + ttmax + self.tpad


class FixedWindow:
    """Fixed absolute cut window (reference ``beatdown.py:195-203``)."""

    def __init__(self, tmin, tmax):
        self.tmin = tmin
        self.tmax = tmax

    def __call__(self, time, distance, depth):
        return self.tmin, self.tmax


def download_waveforms(event, project_dir, radius_deg=(3.0, 90.0),
                       channels="BH[ZNE]", padding=600.0,
                       duration=3600.0, datadir="raw",
                       sites=("IRIS",), credentials=None):
    """
    FDSN mass download around an event (reference ``beatdown.main``
    ``apps/beatdown.py:248-1227``; gated on obspy + network egress):
    circular station domain, one chunked request per provider, StationXML
    inventories next to the waveforms.  Afterwards run
    :func:`beat_tpu_torch.inputf.load_obspy_traces` + :func:`prepare_local_traces`.

    event : dict with time [epoch s], lat, lon (e.g. from
        :func:`get_events`).
    sites : FDSN provider names queried in order — every reachable one
        contributes (reference multi-site loop ``beatdown.py:215-247``).
    credentials : optional ``{site: {"user":…, "passwd":…, "token":…}}``
        for restricted-data providers (reference ``get_user_credentials``).
    """
    try:
        from obspy import UTCDateTime
        from obspy.clients.fdsn import Client
        from obspy.clients.fdsn.mass_downloader import (
            CircularDomain, MassDownloader, Restrictions)
    except ImportError as e:
        raise ImportError(
            "obspy is required for FDSN downloads; in offline environments "
            "use prepare_local_traces on existing files") from e
    import os

    providers = []
    for site in sites:
        cred = dict((credentials or {}).get(site, {}))
        try:
            if cred.get("token"):
                client = Client(site)
                if hasattr(client, "set_eida_token"):
                    client.set_eida_token(cred["token"])
            elif cred.get("user"):
                client = Client(site, user=cred["user"],
                                password=cred.get("passwd"))
            else:
                client = Client(site)
            providers.append(client)
        except Exception as e:
            logger.warning("FDSN site %s unavailable: %s", site, e)
    if not providers:
        raise RuntimeError(f"none of the FDSN sites {sites} are reachable")

    t0 = UTCDateTime(event["time"])
    domain = CircularDomain(latitude=event["lat"], longitude=event["lon"],
                            minradius=radius_deg[0], maxradius=radius_deg[1])
    restrictions = Restrictions(
        starttime=t0 - padding, endtime=t0 + duration + padding,
        chunklength_in_sec=duration + 2 * padding,
        channel_priorities=[channels], reject_channels_with_gaps=True,
        minimum_length=0.9, minimum_interstation_distance_in_m=1e3)
    wf_dir = os.path.join(project_dir, datadir, "waveforms")
    inv_dir = os.path.join(project_dir, datadir, "stations")
    mdl = MassDownloader(providers=providers)
    mdl.download(domain, restrictions, mseed_storage=wf_dir,
                 stationxml_storage=inv_dir)
    logger.info("Downloaded waveforms -> %s, inventories -> %s",
                wf_dir, inv_dir)
    return wf_dir, inv_dir


def bandpass_and_decimate(ydata, dt, target_dt, lower=0.01, upper=None,
                          order=4):
    """Anti-aliased resampling onto ``target_dt`` + zero-phase band
    limiting (the reference's restitution-stage filtering/downsampling).

    Resampling first: ``resample_poly`` applies its own FIR anti-alias
    low-pass, and the IIR corners are then specified at the TARGET rate
    — a single Butterworth bandpass at the raw rate has normalized
    corners of ~1e-3 and is numerically unstable (it can pass, even
    amplify, far-out-of-band energy).  Low-pass and high-pass apply as
    separate stable sections."""
    from fractions import Fraction

    from scipy.signal import butter, resample_poly, sosfiltfilt

    frac = Fraction(dt / target_dt).limit_denominator(1000)
    out = resample_poly(np.asarray(ydata, dtype=np.float64),
                        frac.numerator, frac.denominator)
    ny = 0.5 / target_dt
    hi = min((upper if upper is not None else 0.4 / target_dt) / ny, 0.99)
    out = sosfiltfilt(butter(order, hi, btype="low", output="sos"), out)
    lo = lower / ny
    if lo > 1e-3:
        out = sosfiltfilt(butter(order, lo, btype="high", output="sos"), out)
    return out


def weed_stations(traces, stations, event_time, snr_min=2.0,
                  noise_window=60.0, blacklist=()):
    """
    Station weeding (reference ``beatdown`` quality control): drop
    blacklisted stations and those whose peak signal amplitude after the
    event is below ``snr_min`` × the pre-event RMS noise.

    traces : dict station -> {channel: (tmin_epoch, dt, ydata)}.
    Returns the filtered (traces, stations).
    """
    keep_traces, keep_stations = {}, {}
    for sta, chans in traces.items():
        if sta in set(blacklist):
            logger.info("Weeding %s: blacklisted", sta)
            continue
        ok = True
        for channel, (tmin, dt, ydata) in chans.items():
            ydata = np.asarray(ydata, dtype=np.float64)
            # noise = the noise_window immediately BEFORE the event
            # onset; signal = everything from the onset on (comparing
            # against the whole pre-event span would let early noise
            # bursts masquerade as signal)
            n_onset = int(np.clip((event_time - tmin) / dt, 0, ydata.size))
            n_noise0 = max(int(n_onset - noise_window / dt), 0)
            pre = ydata[n_noise0:max(n_onset, 1)]
            if pre.size < 2 or n_onset >= ydata.size:
                logger.info("Weeding %s.%s: no usable pre-event noise or "
                            "signal window", sta, channel)
                ok = False
                break
            noise = np.sqrt(np.mean(pre**2)) + 1e-30
            snr = np.abs(ydata[n_onset:]).max() / noise
            if snr < snr_min:
                logger.info("Weeding %s.%s: SNR %.2f < %.2f",
                            sta, channel, snr, snr_min)
                ok = False
                break
        if ok:
            keep_traces[sta] = chans
            if sta in stations:
                keep_stations[sta] = stations[sta]
    logger.info("Weeding kept %i / %i stations", len(keep_traces), len(traces))
    return keep_traces, keep_stations


def rotate_to_rtz(north, east, back_azimuth_rad):
    """NE -> RT rotation (R away from event; reference restitution+
    rotation pipeline)."""
    ba = back_azimuth_rad
    r = -north * np.cos(ba) - east * np.sin(ba)
    t = north * np.sin(ba) - east * np.cos(ba)
    return r, t


def prepare_local_traces(traces, stations, event, table, project_dir,
                         datadir="./", cut_window=None):
    """
    Prepare locally available traces into the native seismic format:
    resample to the GF-table grid, rotate horizontals to (R, T), align the
    time axis to ``table.t0`` after origin, persist via
    :func:`beat_tpu_torch.inputf.save_seismic_datasets`.

    traces : dict station -> {channel: (tmin_epoch, dt, ydata)}
    stations : dict station -> (east, north) local coordinates [m]
    event : dict with 'time' epoch [s] (and 'depth' [m] for phase/velocity
        cut windows)
    cut_window : optional window selector called as
        ``(event_time, distance, depth) -> (tmin_abs, tmax_abs)`` —
        :class:`PhaseWindow`, :class:`VelocityWindow` or
        :class:`FixedWindow` (reference ``cut_n_dump`` ``beatdown.py:100``);
        samples outside the window are zeroed out, stations whose window
        cannot be computed (:class:`NoArrival`) are skipped.
    """
    from beat_tpu_torch.heart.seismic import SeismicDataset
    from beat_tpu_torch.inputf import save_seismic_datasets

    datasets = []
    for station, chans in traces.items():
        e, n = stations[station]
        back_az = np.arctan2(-e, -n)  # station -> event azimuth
        window = None
        if cut_window is not None:
            try:
                window = cut_window(event["time"], float(np.hypot(e, n)),
                                    float(event.get("depth", 0.0)))
            except NoArrival as err:
                logger.info("Skipping %s: %s", station, err)
                continue
        comps = {}
        for channel, (tmin, dt, ydata) in chans.items():
            if window is not None:
                ydata = np.asarray(ydata, dtype=np.float64).copy()
                idx = tmin + np.arange(ydata.size) * dt
                ydata[(idx < window[0]) | (idx > window[1])] = 0.0
            grid = _to_table_grid(ydata, tmin, dt, event["time"], table)
            comps[channel[-1].upper()] = grid
        if "N" in comps and "E" in comps:
            r, t = rotate_to_rtz(comps.pop("N"), comps.pop("E"), back_az)
            comps["R"], comps["T"] = r, t
        for channel, ydata in comps.items():
            datasets.append(SeismicDataset(station=station, channel=channel,
                                           east=e, north=n, ydata=ydata))
    path = save_seismic_datasets(datasets, project_dir, datadir)
    logger.info("Prepared %i traces -> %s", len(datasets), path)
    return datasets


def _to_table_grid(ydata, tmin, dt, event_time, table):
    """Resample/align one trace onto the GF table time grid.  When
    downsampling, the trace is first anti-alias filtered + decimated
    (:func:`bandpass_and_decimate`) so energy above the table Nyquist
    does not fold into the fit band; the final alignment interpolation
    then happens near the target rate."""
    ydata = np.asarray(ydata, dtype=np.float64)
    if table.dt > 1.5 * dt:
        ydata = bandpass_and_decimate(ydata, dt, table.dt)
        dt = table.dt  # resample_poly lands on the target rate
    t_src = tmin - event_time + np.arange(len(ydata)) * dt
    t_dst = table.t0 + np.arange(table.nt) * table.dt
    return np.interp(t_dst, t_src, ydata, left=0.0, right=0.0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="beat-tpu-torch-down",
        description="waveform acquisition & preparation "
                    "(reference beatdown; FDSN access gated on obspy)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_dl = sub.add_parser("download", help="FDSN mass download around an event")
    p_dl.add_argument("project_dir")
    p_dl.add_argument("--time", required=True, help="event time (UTC ISO)")
    p_dl.add_argument("--lat", type=float, required=True)
    p_dl.add_argument("--lon", type=float, required=True)
    p_dl.add_argument("--radius", type=float, nargs=2, default=(3.0, 90.0))

    p_pr = sub.add_parser("prepare", help="prepare downloaded/local data "
                          "into the native seismic format")
    p_pr.add_argument("project_dir")
    p_pr.add_argument("--datadir", default="raw/waveforms")
    p_pr.add_argument("--inventory", default=None)
    p_pr.add_argument("--event-time", type=float, required=True)
    p_pr.add_argument("--snr-min", type=float, default=2.0)

    args = parser.parse_args(argv)
    try:
        if args.cmd == "download":
            download_waveforms({"time": args.time, "lat": args.lat,
                                "lon": args.lon}, args.project_dir,
                               radius_deg=tuple(args.radius))
        elif args.cmd == "prepare":
            import os

            from beat_tpu_torch.inputf import load_obspy_traces

            # datadir is relative to the project dir the download wrote
            # into (unless given absolute)
            datadir = (args.datadir if os.path.isabs(args.datadir)
                       else os.path.join(args.project_dir, args.datadir))
            traces, stations = load_obspy_traces(datadir, args.inventory)
            traces, stations = weed_stations(traces, stations,
                                             args.event_time,
                                             snr_min=args.snr_min)
            print(f"prepared {len(traces)} stations; finish with "
                  "prepare_local_traces once the GF table exists")
    except ImportError as e:
        print(f"beat-tpu-torch-down: {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
