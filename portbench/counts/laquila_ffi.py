"""
The floating-point work of one chain's log-likelihood in the
``laquila_ffi`` configuration, counted from its shapes: the eikonal
onsets (about 20 flops a patch in each of n_strike + n_dip sweeps of the
grid, the least that reaches every patch), the library stack (one
multiply-add per sample for each target, patch and multilinear corner:
K3's count), the whitened misfit of a diagonal covariance (3 a sample)
and the Laplacian prior (a multiply-add per neighbour pair of each
patch, with the square and sum).
"""


def llk_flops(config: dict) -> float:
    f = config["fault"]
    P = f["n_strike"] * f["n_dip"]
    T, N = config["stations"]["n"], config["window"]["samples"]
    eikonal = 20 * P * (f["n_strike"] + f["n_dip"])
    stack = 2 * 4 * T * P * N
    misfit = 3 * T * N
    laplacian = 2 * 5 * P + 2 * P
    return float(eikonal + stack + misfit + laplacian)
