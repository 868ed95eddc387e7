"""
The published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet,
dense rates, at the full 700 W power limit), frozen here: the roofline
shares and the step's share of the peak are taken against them.
"""

HBM_BYTES_PER_S = 3.35e12       # HBM3
FP32_FLOPS_PER_S = 67e12        # float32 on the CUDA cores
BF16_FLOPS_PER_S = 989e12       # bfloat16 on the tensor cores, float32 sums


def least_seconds(n_bytes: float, n_flops: float, flops_per_s: float = FP32_FLOPS_PER_S) -> float:
    """The least time the card could take for the work: the larger of its
    bytes at the memory's rate and its operations at ``flops_per_s``."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / flops_per_s)
