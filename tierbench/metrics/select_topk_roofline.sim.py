"""``select_topk_roofline.sim``: the least time the traced ``select_topk``
launches could take on an H100 (their bytes at HBM bandwidth; they do no
floating-point work) as a share of the device time the profiler gives
them."""

from tierbench.metrics._trace_math import (HBM_BYTES_PER_S, clipped,
                                           select_topk_cost)


def read(trace):
    shapes = set(trace["shapes"].get("select_topk") or ())
    launches = clipped(((s, e) for name, s, e in trace["device"]
                        if "select_topk" in name), trace["window"])
    if len(shapes) != 1 or not launches:
        return None  # no launch, or launches of more than one shape
    _, nbytes = select_topk_cost(*shapes.pop())
    least_s = len(launches) * nbytes / HBM_BYTES_PER_S
    device_s = sum(e - s for s, e in launches) / 1e9
    return 100.0 * least_s / device_s
