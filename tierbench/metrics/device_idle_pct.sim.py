"""``device_idle_pct.sim``: the share of the traced stretch of whole passes
in which no device activity ran, both measured in the same trace."""

from tierbench.metrics._trace_math import busy_ns


def read(trace):
    if not trace["device"]:
        return None
    lo, hi = trace["window"]
    return 100.0 * (1.0 - busy_ns(trace) / (hi - lo))
