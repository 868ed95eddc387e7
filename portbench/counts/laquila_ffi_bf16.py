"""
The floating-point work of one chain's log-likelihood in the
``laquila_ffi_bf16`` configuration: ``laquila_ffi``'s, since the storage
type of the library changes no operation (its products are summed in
float32 either way).
"""

from portbench.counts.laquila_ffi import llk_flops  # noqa: F401
