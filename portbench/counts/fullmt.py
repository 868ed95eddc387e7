"""
The floating-point work of one chain's log-likelihood in the ``fullmt``
configuration, counted from its shapes: for every target the fused
gather and moment-tensor contraction (24 multiply-adds per spectral
value, K1c's count), the filter and the source's phasor and
source-time function (two complex products per frequency, 6 flops
each), the tapered window of the inverse DFT (a multiply-add per
frequency, window sample and real or imaginary part) and the whitened
misfit of a diagonal covariance (a product, a square and a sum per
sample).  The per-chain source terms (the moment tensor, its rotation)
are left out: a few hundred flops.
"""



def llk_flops(config: dict) -> float:
    tb = config["table"]
    nf = tb["nt"] // 2 + 1
    targets = sum(len(w["channels"]) for w in config["wavemaps"]) * config["stations"]["n"]
    t = config["taper"]
    n_win = int(round((t["d"] - t["a"]) / tb["dt"]))
    per_target = 2 * 24 * 2 * nf + 2 * 6 * nf + 2 * 2 * nf * n_win + 3 * n_win
    return float(targets * per_target + 6 * nf)
