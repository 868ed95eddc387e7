"""K3's share of its roofline on a bfloat16 library in the profiled
steps, per cent: the least time of the work its calls needed
(``counts/k3.py``: 2-byte rows, products at the tensor cores' peak) over
the device time of the operations launched inside the ``k3`` span.  None
where any captured call's library is not bfloat16, so it never reads
the float32 kernel."""

import torch

from portbench.counts import k3
from portbench.counts.peaks import least_seconds


def read(record):
    t = record.trace
    if t is None or not record.k3_calls or not t.span_device_s.get("k3"):
        return None
    if any(a[0].dtype != torch.bfloat16 for a, _ in record.k3_calls):
        return None
    least = sum(least_seconds(*k3.call_work(a, kw)) for a, kw in record.k3_calls)
    return 100.0 * least / t.span_device_s["k3"]
