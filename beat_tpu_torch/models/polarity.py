"""
Polarity composite: the first-motion likelihood (port of
``beat_tpu/models/polarity.py``), batched over a leading chain axis.

Several phase maps fit jointly: each has its own phase (P/SH/SV
radiation pattern), targets, hyperparameter ``h_<wavename>_pol_<i>`` and,
in multi-event problems, its own source via ``event_idx``.  The moment
tensor of each chain is normalised by its own max |m6|.

When the source location is sampled and a map has a
:class:`~beat_tpu_torch.heart.polarity.TakeoffTable`, distance, azimuth
and takeoff are re-derived for every chain's location: the stations' NE
offsets from the catalog origin are fixed, and the takeoff is a bilinear
gather from the table, so one evaluation is a handful of (C, n) tensor
operations.  Without a table, or when no location key is sampled, the
weights frozen at load time are used.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from beat_tpu_torch.device import DTYPE, resolve
from beat_tpu_torch.distributions import polarity_llk
from beat_tpu_torch.heart.polarity import (TakeoffTable, pol_synthetics, radiation_weights,
                                           takeoff_vector)
from beat_tpu_torch.models.base import Composite
from beat_tpu_torch.models.seismic import point_getter, source_m6

logger = logging.getLogger("beat_tpu_torch.models.polarity")

#: sampled point keys that move the source and hence the ray geometry
LOCATION_KEYS = ("depth", "east_shift", "north_shift")


class PolarityMapping:
    """One polarity phase map: targets sharing a phase and radiation
    pattern, its tensors on ``device``.

    ``takeoff_table`` (on the same device) enables per-draw geometry: it
    needs every target's epicentral ``distance_m`` from the catalog
    origin, from which the station NE offsets are fixed."""

    def __init__(self, wavename, targets, event_idx=0, mapnumber=0,
                 takeoff_table: TakeoffTable | None = None, *, device):
        dev = resolve(device)
        self.wavename = wavename
        self.targets = list(targets)
        self.event_idx = int(event_idx)
        self.mapnumber = int(mapnumber)
        self.takeoff_table = takeoff_table

        def f32(values):
            return torch.as_tensor(np.asarray(values, dtype=np.float64), dtype=DTYPE, device=dev)

        az = f32([t.azimuth_rad for t in self.targets])
        to = f32([t.takeoff_rad for t in self.targets])
        self.weights = radiation_weights(wavename, takeoff_vector(az, to), az, to)
        self.obs = f32([t.polarity for t in self.targets])
        if takeoff_table is not None:
            if takeoff_table.angles_rad.device != dev:
                raise ValueError(f"takeoff table on {takeoff_table.angles_rad.device}, "
                                 f"polarity map on {dev}")
            dist = [t.distance_m for t in self.targets]
            if any(d is None for d in dist):
                raise ValueError(
                    f"polarity map {self.hypername}: per-draw takeoff re-interpolation "
                    "needs distance_m on every target")
            dist = np.asarray(dist, dtype=float)
            azn = np.asarray([t.azimuth_rad for t in self.targets])
            # station NE offsets from the catalog origin (shifts == 0)
            self.station_n = f32(dist * np.cos(azn))
            self.station_e = f32(dist * np.sin(azn))

    @property
    def hypername(self) -> str:
        return f"h_{self.wavename}_pol_{self.mapnumber}"


class PolarityComposite(Composite):
    name = "polarity"

    def __init__(self, targets=None, sources=(), wavename="any_P", gamma=0.01, maps=None, *,
                 device):
        """
        targets : list of :class:`~beat_tpu_torch.heart.polarity.PolarityTarget`
            (single-map shorthand; ignored when ``maps`` is given)
        sources : source templates (point sources with a moment tensor);
            multi-event problems use ``sources[map.event_idx]`` per map
        maps : list of :class:`PolarityMapping` fit jointly
        gamma : probability of a wrong polarity reading.
        """
        super().__init__()
        self.device = resolve(device)
        if maps is None:
            maps = [PolarityMapping(wavename, targets, device=self.device)]
        self.maps = list(maps)
        self.sources = list(sources)
        self.gamma = gamma
        if not self.sources:
            raise ValueError("PolarityComposite needs at least one source template (the "
                             "radiation pattern has nothing to evaluate without one)")
        for m in self.maps:
            if not (0 <= m.event_idx < len(self.sources)):
                raise ValueError(f"polarity map {m.hypername}: event_idx {m.event_idx} "
                                 f"outside [0, {len(self.sources)})")
            if m.obs.device != self.device:
                raise ValueError(f"polarity map {m.hypername} on {m.obs.device}, "
                                 f"composite on {self.device}")
        logger.info("Polarity composite: %i maps, %i targets total", len(self.maps),
                    sum(len(m.targets) for m in self.maps))

    def get_hypernames(self):
        return [m.hypername for m in self.maps]

    def device_data(self) -> list:
        out = []
        for m in self.maps:
            dev = {"weights": m.weights, "obs": m.obs}
            if m.takeoff_table is not None:
                dev.update(m.takeoff_table.as_device())
                dev["station_n"] = m.station_n
                dev["station_e"] = m.station_e
            out.append(dev)
        return out

    def _getter(self, m, point: dict, n_chains: int, dtype):
        return point_getter(self.sources[m.event_idx], point, m.event_idx, len(self.sources),
                            n_chains, self.device, dtype)

    def _traced_weights(self, m, dev: dict, point: dict, get):
        """Radiation weights (C, n, 6) for each chain's source location,
        re-derived from the fixed station offsets and the takeoff table;
        the frozen (n, 6) weights when no table is attached or the
        location is not sampled."""
        if "station_n" not in dev or not any(k in point for k in LOCATION_KEYS):
            return dev["weights"]
        vn = dev["station_n"] - get("north_shift")[:, None]
        ve = dev["station_e"] - get("east_shift")[:, None]
        dist = torch.sqrt(vn * vn + ve * ve)
        az = torch.atan2(ve, vn)
        to = TakeoffTable.from_device(dev).interp(get("depth"), dist)
        return radiation_weights(m.wavename, takeoff_vector(az, to), az, to)

    def _amplitudes(self, m, dev: dict, point: dict):
        """(C, n) radiation amplitudes of the max-normalised moment tensors."""
        n_chains = next(iter(point.values())).shape[0]
        get = self._getter(m, point, n_chains, dev["obs"].dtype)
        m6 = source_m6(self.sources[m.event_idx], get)
        m6n = m6 / torch.clamp(torch.amax(torch.abs(m6), dim=-1, keepdim=True), min=1e-30)
        return pol_synthetics(m6n, self._traced_weights(m, dev, point, get))

    def _map_llk(self, m, dev: dict, point: dict, src_point: dict):
        amps = self._amplitudes(m, dev, src_point)
        h = point.get(m.hypername)
        sigma = 1.0 if h is None else torch.exp(h.reshape(-1, 1))
        return torch.sum(polarity_llk(dev["obs"], amps, self.gamma, sigma), dim=-1)

    def loglike(self, point: dict, data=None) -> torch.Tensor:
        """(C,) first-motion log-likelihood of a batch of chains."""
        data = self.device_data() if data is None else data
        return sum(self._map_llk(m, dev, point, point) for m, dev in zip(self.maps, data))

    def _batch_of_one(self, point: dict, dtype=DTYPE) -> dict:
        return {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=self.device)[None]
                for k, v in point.items()}

    def hyper_loglike(self, point: dict, fixed_point: dict, data=None) -> torch.Tensor:
        """(C,) log-likelihood of the chains' hyperparameters with the
        amplitudes of one ``fixed_point`` (no chain axis)."""
        data = self.device_data() if data is None else data
        fixed = self._batch_of_one(fixed_point)
        return sum(self._map_llk(m, dev, point, fixed) for m, dev in zip(self.maps, data))

    def get_synthetics(self, point: dict) -> dict:
        """Predicted polarities (signs) per map at one point (no chain
        axis), numpy; a single map also under ``polarities``."""
        batched = self._batch_of_one(point)
        out = {}
        with torch.no_grad():
            for m, dev in zip(self.maps, self.device_data()):
                amps = self._amplitudes(m, dev, batched)[0]
                out[f"{m.wavename}_pol_{m.mapnumber}"] = np.sign(amps.double().cpu().numpy())
        if len(self.maps) == 1:
            out["polarities"] = next(iter(out.values()))
        return out
