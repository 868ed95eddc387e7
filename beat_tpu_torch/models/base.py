"""
Composite interface (port of ``beat_tpu/models/base.py``).

A composite owns one datatype's datasets, noise model and forward
model, and contributes ``loglike(point, data) -> (C,)`` for a batch of
C chains, the hyperparameter-only ``hyper_loglike`` on residuals fixed
at one point, its hyperparameter and hierarchical names, and the
between-stage ``update_weights``.  ``data`` is the composite's device
data (:meth:`Composite.device_data`), passed as an argument so callers
can swap it (for example a composite rebuilt from the JAX package's
arrays, :mod:`beat_tpu_torch.convert`).
"""

from __future__ import annotations

import torch
from torch import nn

from beat_tpu_torch.parameter import Parameter


def dataset_hyper_terms(residuals, weights, slog_pdets, nsamples, names) -> tuple:
    """Fixed-residual terms of the hyper-only posterior for datasets of
    different sizes, one residual (M_d,) and weight matrix (M_d, M_d)
    each: ``(||W r||² (D,), slog_pdets (D,), nsamples (D,), hyper names)``."""
    wrw = []
    for r, w in zip(residuals, weights):
        tmp = w @ r
        wrw.append(torch.dot(tmp, tmp))
    wrw = torch.stack(wrw)
    return (wrw, torch.stack([torch.as_tensor(p, dtype=wrw.dtype, device=wrw.device)
                              for p in slog_pdets]),
            torch.as_tensor(nsamples, dtype=wrw.dtype, device=wrw.device), list(names))


def wavemap_hyper_terms(devs, synths, wavemaps, hp_specific: bool) -> tuple:
    """Fixed-residual terms of the hyper-only posterior
    (:func:`~beat_tpu_torch.distributions.hyper_normal`) for every target
    of every wavemap: ``(||W r||² (D,), slog_pdets (D,), nsamples (D,),
    hyper names (D,))``.  ``devs`` carry (D_w, M) data and (D_w, M, M)
    weights; ``synths`` are the fit-space synthetics (D_w, M) at the fixed
    point."""
    wrw, pds, ns, names = [], [], [], []
    for dev, synth, wmap in zip(devs, synths, wavemaps):
        tmp = torch.einsum("dij,dj->di", dev["weights"], dev["data"] - synth)
        wrw.append(torch.sum(tmp * tmp, dim=-1))
        pds.append(dev["slog_pdets"])
        ns.append(dev["nsamples"])
        if hp_specific:
            names.extend(f"{wmap.hypername}_{i}" for i in range(wmap.ntargets))
        else:
            names.extend([wmap.hypername] * wmap.ntargets)
    return torch.cat(wrw), torch.cat(pds), torch.cat(ns), names


def _strip_prefix(name: str) -> str:
    """The registry key of a hierarchical name: '<dataset>_azimuth_ramp'
    -> 'ramp', '<n>_pole_lat' -> 'lat', '<...>_time_shift' ->
    'time_shift', and so on."""
    for suffix, key in (
            ("azimuth_ramp", "ramp"), ("range_ramp", "ramp"), ("offset", "offset"),
            ("pole_lat", "lat"), ("pole_lon", "lon"), ("omega", "omega"),
            ("exx", "exx"), ("eyy", "eyy"), ("exy", "exy"), ("rotation", "rotation"),
            ("time_shift", "time_shift")):
        if name.endswith(suffix):
            return key
    return name


class Composite(nn.Module):
    name = "composite"

    def device_data(self):
        """The tensors the likelihood consumes (data vectors, weights,
        GF tables)."""
        raise NotImplementedError

    def loglike(self, point: dict, data=None):
        raise NotImplementedError

    def hyper_loglike(self, point: dict, fixed_point: dict, data=None):
        raise NotImplementedError

    def get_hypernames(self) -> list[str]:
        return []

    def get_hyper_parameters(self) -> list[Parameter]:
        return [Parameter.from_defaults(name) for name in self.get_hypernames()]

    def get_hierarchical_names(self) -> list[str]:
        return []

    def get_hierarchical_parameters(self) -> list[Parameter]:
        out = []
        for name in self.get_hierarchical_names():
            p = Parameter.from_defaults(_strip_prefix(name))
            p.name = name        # the registry's bounds, the hierarchical's own name
            out.append(p)
        return out

    def update_weights(self, point: dict) -> None:
        """Re-estimate data covariances at ``point`` (no-op by default)."""

    # diagnostics at one point (no chain axis); a composite without data
    # of its own (the Laplacian smoothing prior) keeps these empty defaults

    def get_synthetics(self, point: dict) -> dict:
        return {}

    def get_standardized_residuals(self, point: dict) -> dict:
        return {}

    def get_variance_reductions(self, point: dict) -> dict:
        return {}
