"""
Boundary-element mode (port of ``beat_tpu/bem``): triangular-mesh
dislocation sources in an elastic half space (or full space) driven by
traction boundary conditions.  Meshes are structured triangulations built
on the host (:mod:`~beat_tpu_torch.bem.sources`); the dislocation kernels,
the matrices and the solve run in float64 on the engine's device
(:mod:`~beat_tpu_torch.bem.tde`, :mod:`~beat_tpu_torch.bem.base`).
"""

from beat_tpu_torch.bem.sources import (  # noqa: F401
    CurvedBEMSource,
    DiskBEMSource,
    EllipseBEMSource,
    RectangularBEMSource,
    RingfaultBEMSource,
    TriangleBEMSource,
    check_intersection,
    source_catalog,
)
from beat_tpu_torch.bem.base import BEMEngine, BEMResponse, BoundaryCondition  # noqa: F401
