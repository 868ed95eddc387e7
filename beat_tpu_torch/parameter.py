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

    def validate_bounds(self) -> None:
        """Check the bounds against the registry's physical bounds."""
        phys = defaults.physical_bounds(self.name.split("_")[-1]
                                        if self.name not in defaults.parameter_info
                                        else self.name)
        lo, hi = phys
        if np.any(self.lower < lo) or np.any(self.upper > hi):
            raise ValueError(f"Parameter '{self.name}' bounds [{self.lower}, {self.upper}] "
                             f"exceed physical bounds {phys}")
        if np.any(self.upper < self.lower):
            raise ValueError(f"Parameter '{self.name}': upper < lower")
        if np.any(self.testvalue < self.lower) or np.any(self.testvalue > self.upper):
            raise ValueError(f"Parameter '{self.name}': testvalue outside bounds")

    def to_dict(self) -> dict:
        return {"name": self.name, "form": self.form, "lower": self.lower.tolist(),
                "upper": self.upper.tolist(), "testvalue": self.testvalue.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "Parameter":
        return cls(name=d["name"], lower=np.asarray(d["lower"]), upper=np.asarray(d["upper"]),
                   testvalue=(np.asarray(d["testvalue"]) if d.get("testvalue") is not None
                              else None),
                   form=d.get("form", "Uniform"))

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

    def __getitem__(self, name) -> Parameter:
        return self.parameters[name]

    @property
    def names(self) -> list:
        return list(self.parameters)

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

    def validate(self) -> None:
        for p in self.parameters.values():
            p.validate_bounds()

    def to_dict(self) -> dict:
        return {name: p.to_dict() for name, p in self.parameters.items()}

    @classmethod
    def from_dict(cls, d: dict) -> "PriorSet":
        ps = cls()
        for pd in d.values():
            ps.add(Parameter.from_dict(pd))
        return ps
