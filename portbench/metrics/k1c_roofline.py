"""K1c's share of its roofline in the profiled steps, per cent: the least
time of the work its calls needed (``counts/k1c.py``) over the device time
of the operations launched inside the ``k1c`` span."""

from portbench.counts import k1c
from portbench.counts.peaks import least_seconds


def read(record):
    t = record.trace
    if t is None or not record.k1c_calls or not t.span_device_s.get("k1c"):
        return None
    least = sum(least_seconds(*k1c.call_work(a, k)) for a, k in record.k1c_calls)
    return 100.0 * least / t.span_device_s["k1c"]
