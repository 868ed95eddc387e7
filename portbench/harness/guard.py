"""
The import guard: a run, and the plain references, may hold no module of
JAX or of the JAX package.  Names are compared by their top-level part
(before the first dot), whole: the port's own name begins with the JAX
package's and is allowed.
"""

from __future__ import annotations

#: top-level module names no run may hold
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "beat_tpu"})
#: top-level module names the plain references may not import
PROGRAM = "beat_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(modules) -> set:
    """The names among ``modules`` whose top level is forbidden."""
    return {name for name in modules if top_level(name) in FORBIDDEN}
