"""
Bounded parameters (priors) and their flat-vector layout (copied from
``beat_tpu/parameter.py``, trimmed to what the port calls).

Priors are uniform boxes over named, possibly vector-valued parameters;
the sampler sees one flat vector whose layout is an
:class:`beat_tpu_torch.utility.Ordering`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from beat_tpu_torch import defaults
from beat_tpu_torch.utility import Ordering


@dataclass
class Parameter:
    """A named, bounded (uniform-prior) parameter vector."""

    name: str
    lower: np.ndarray
    upper: np.ndarray
    testvalue: np.ndarray | None = None
    form: str = "Uniform"

    def __post_init__(self):
        self.lower = np.atleast_1d(np.asarray(self.lower, dtype=np.float64))
        self.upper = np.atleast_1d(np.asarray(self.upper, dtype=np.float64))
        if self.testvalue is None:
            self.testvalue = (self.lower + self.upper) / 2.0
        self.testvalue = np.atleast_1d(np.asarray(self.testvalue, dtype=np.float64))
        if not (self.lower.shape == self.upper.shape == self.testvalue.shape):
            raise ValueError(f"Parameter {self.name}: inconsistent bound shapes")

    @property
    def dimension(self) -> int:
        return self.lower.size

    @classmethod
    def from_defaults(cls, name: str, dimension: int = 1) -> "Parameter":
        lo, hi = defaults.default_bounds(name)
        return cls(name=name, lower=np.full(dimension, lo), upper=np.full(dimension, hi))


@dataclass
class PriorSet:
    """An ordered collection of :class:`Parameter` priors defining the
    sampled space: its flat-vector :class:`Ordering`, bound arrays and
    test point."""

    parameters: dict[str, Parameter] = field(default_factory=dict)

    def add(self, param: Parameter) -> "PriorSet":
        self.parameters[param.name] = param
        return self

    def __contains__(self, name):
        return name in self.parameters

    @property
    def ordering(self) -> Ordering:
        return Ordering([(p.name, (p.dimension,) if p.dimension > 1 else ())
                         for p in self.parameters.values()])

    def bounds_arrays(self):
        """(lower, upper) flat float64 arrays matching the ordering."""
        lo = np.concatenate([p.lower for p in self.parameters.values()])
        hi = np.concatenate([p.upper for p in self.parameters.values()])
        return lo, hi

    def test_array(self) -> np.ndarray:
        return np.concatenate([p.testvalue for p in self.parameters.values()])

    def test_point(self) -> dict:
        """``{name: test value}``, scalars for one-element parameters."""
        return {p.name: (p.testvalue.copy() if p.dimension > 1 else float(p.testvalue[0]))
                for p in self.parameters.values()}
