"""Arithmetic the per-layer readers share: the union of device activity,
kernel times by name, and the least time of a ``select_topk`` launch.

A trace here is the dict the harness hands every reader:

* ``device``: ``[(name, start_ns, end_ns), ...]`` of every device activity
  (kernels, copies, sets) that overlaps the traced stretch;
* ``host``: the same for host events (operators, runtime calls, spans);
* ``window``: ``(start_ns, end_ns)`` of the traced stretch: from the start
  of its first whole pass to the end of its last;
* ``shapes``: what the cell's driver reports of the traced passes (e.g.
  ``epochs``, and ``select_topk``'s ``(rows, pages)`` per pass).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

#: NVIDIA H100 SXM, published: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12


def clipped(intervals: Iterable[Tuple[float, float]],
            window: Tuple[float, float]) -> List[Tuple[float, float]]:
    lo, hi = window
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def union_ns(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_ns(trace) -> float:
    """Nanoseconds of the traced stretch in which the device was active."""
    return union_ns(clipped(((s, e) for _, s, e in trace["device"]),
                            trace["window"]))


def gaps(trace) -> List[Tuple[float, float]]:
    """The stretches of the window in which no device activity ran."""
    lo, hi = trace["window"]
    out, t = [], lo
    for s, e in sorted(clipped(((s, e) for _, s, e in trace["device"]),
                               trace["window"])):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def time_by_name(events) -> Dict[str, float]:
    """Summed nanoseconds of each event name."""
    out: Dict[str, float] = {}
    for name, s, e in events:
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def select_topk_cost(rows: int, pages: int) -> Tuple[int, int]:
    """(floating-point operations, bytes) that one ``select_topk`` launch
    over ``rows`` x ``pages`` needs, each input byte read once and each
    output byte written once.

    Inputs: the promote and demote candidate masks (1 byte a page each),
    the promote and demote priorities (float32, 4 bytes a page each) and
    the two per-row counts (float32).  Outputs: the two selection masks
    (1 byte a page each).  So ``12 * rows * pages + 8 * rows`` bytes.  The
    selection compares order-preserving integer keys and does no
    floating-point arithmetic, so the bound is the bytes at HBM bandwidth.
    """
    return 0, 12 * rows * pages + 8 * rows
