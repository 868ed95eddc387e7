"""
Finite-fault inversion (FFI): fault discretization, the 5-D kinematic
Green's-function library and its stack.
"""

from beat_tpu_torch.ffi.fault import (FaultGeometry, FaultOrdering,  # noqa: F401
                                      SubfaultGrid, discretize_sources, extend_plane)
from beat_tpu_torch.ffi.gflibrary import (SeismicGFLibrary,  # noqa: F401
                                          seis_construct_gf_linear, stack_all_numpy)
from beat_tpu_torch.ffi.laplacian import (  # noqa: F401
    get_smoothing_operator_correlated,
    get_smoothing_operator_nearest_neighbor,
    smoothing_operator_log_determinant,
)
