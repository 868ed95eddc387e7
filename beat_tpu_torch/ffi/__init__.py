"""
Finite-fault inversion (FFI): fault discretization (uniform, and
resolution-based in :mod:`beat_tpu_torch.ffi.discretization`), the static
geodetic GF library and its product, and the 5-D kinematic GF library
and its stack.
"""

from beat_tpu_torch.ffi.fault import (FaultGeometry, FaultOrdering,  # noqa: F401
                                      SubfaultGrid, discretize_sources, extend_plane,
                                      write_fault_to_pscmp)
from beat_tpu_torch.ffi.gflibrary import (GeodeticGFLibrary, SeismicGFLibrary,  # noqa: F401
                                          geo_construct_gf_linear, seis_construct_gf_linear,
                                          stack_all_numpy)
from beat_tpu_torch.ffi.laplacian import (  # noqa: F401
    get_smoothing_operator_correlated,
    get_smoothing_operator_nearest_neighbor,
    smoothing_operator_log_determinant,
)
