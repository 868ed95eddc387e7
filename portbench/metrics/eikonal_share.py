"""Per cent of the ``logp`` span's host time inside the onset solve's span,
in the profiled steps."""


def read(record):
    t = record.trace
    if t is None or not t.span_host_s.get("eikonal") or not t.span_host_s.get("logp"):
        return None
    return 100.0 * t.span_host_s["eikonal"] / t.span_host_s["logp"]
