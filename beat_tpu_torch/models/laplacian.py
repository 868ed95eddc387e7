"""
Laplacian smoothing pseudo-composite for distributed-slip priors (port
of ``beat_tpu/models/laplacian.py``), batched over chains.

Adds, per slip component m, the Gaussian smoothness prior

    -0.5 * ( -log|LᵀL| + npatch·(log 2π + 2h) + e^{-2h}·‖L·m‖² )

with smoothing strength hyperparameter ``h_laplacian``; its hyper-only
posterior (``hyper_loglike``) holds the slips of one fixed point.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from beat_tpu_torch.device import DTYPE, resolve
from beat_tpu_torch.ffi.laplacian import smoothing_operator_log_determinant
from beat_tpu_torch.models.base import Composite

logger = logging.getLogger("beat_tpu_torch.models.laplacian")

LOG_2PI = math.log(2.0 * math.pi)
HYPER_NAME = "h_laplacian"


class LaplacianDistributerComposite(Composite):
    name = "laplacian"

    def __init__(self, fault, slip_varnames=("uparr",),
                 correlation_function="nearest_neighbor", *, device):
        super().__init__()
        self.fault = fault
        self.slip_varnames = list(slip_varnames)
        smooth = fault.get_smoothing_operator(correlation_function)
        self.register_buffer("smoothing_op", torch.as_tensor(smooth, dtype=DTYPE,
                                                             device=resolve(device)))
        self.slog_det = float(smoothing_operator_log_determinant(smooth))
        self.npatches = smooth.shape[0]
        logger.info("Laplacian composite: %i patches, logdet %.2f", self.npatches,
                    self.slog_det)

    def get_hypernames(self):
        return [HYPER_NAME]

    def device_data(self):
        return {"smoothing_op": self.smoothing_op}

    def _log_prior(self, slips: dict, h, op: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for var in self.slip_varnames:
            Lm = slips[var] @ op.T
            exponent = torch.sum(Lm * Lm, dim=-1)
            total = total + (-0.5) * (
                -self.slog_det
                + self.npatches * (LOG_2PI + 2.0 * h)
                + torch.exp(-2.0 * torch.as_tensor(h, dtype=op.dtype)) * exponent)
        return total

    def loglike(self, point: dict, data=None) -> torch.Tensor:
        """(C,) smoothness log-prior of a batch of chains."""
        op = self.smoothing_op if data is None else data["smoothing_op"]
        return self._log_prior(point, point.get(HYPER_NAME, 0.0), op)

    def hyper_loglike(self, point: dict, fixed_point: dict, data=None) -> torch.Tensor:
        """(C,) smoothness log-prior of the chains' ``h_laplacian`` with
        the slips of one ``fixed_point`` (no chain axis)."""
        op = self.smoothing_op if data is None else data["smoothing_op"]
        slips = {var: torch.as_tensor(np.asarray(fixed_point[var]), dtype=op.dtype,
                                      device=op.device) for var in self.slip_varnames}
        return self._log_prior(slips, point.get(HYPER_NAME, 0.0), op)
