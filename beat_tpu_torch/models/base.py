"""
Composite interface (port of ``beat_tpu/models/base.py``).

A composite owns one datatype's datasets, noise model and forward
model, and contributes ``loglike(point, data) -> (C,)`` for a batch of
C chains plus its hyperparameter names.  ``data`` is the composite's
device data (:meth:`Composite.device_data`), passed as an argument so
callers can swap it (for example a composite rebuilt from the JAX
package's arrays, :mod:`beat_tpu_torch.convert`).
"""

from __future__ import annotations

from torch import nn

from beat_tpu_torch.parameter import Parameter


class Composite(nn.Module):
    name = "composite"

    def device_data(self):
        """The tensors the likelihood consumes (data vectors, weights,
        GF tables)."""
        raise NotImplementedError

    def loglike(self, point: dict, data=None):
        raise NotImplementedError

    def get_hypernames(self) -> list[str]:
        return []

    def get_hyper_parameters(self) -> list[Parameter]:
        return [Parameter.from_defaults(name) for name in self.get_hypernames()]

    def get_hierarchical_parameters(self) -> list[Parameter]:
        return []
