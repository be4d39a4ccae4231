"""Arithmetic the span readers share: the program's host spans against the
device's idle gaps and the CUDA runtime calls, all on the profiler's clock.

``repro_torch`` names each layer of a ``Study.run`` pass with a host span
while a profiler records (``repro_torch.spans``): ``repro_torch.study.run``
holds ``repro_torch.workload.build``, ``repro_torch.sim.trace_upload``,
``repro_torch.sim.engine_setup``, one ``repro_torch.sim.epoch`` an epoch
(holding ``.first_touch``, ``.observe``, ``.plan`` with ``.select`` in it,
and ``.cost``) and ``repro_torch.sim.results``.  Spans nest on one thread,
so a reader groups events by containment.  A program without the spans
(an older commit) gives every reader here ``None``, as does a trace with
no device activity: it measured no card.
"""

from __future__ import annotations

from bisect import bisect_right
from statistics import median
from typing import Iterable, List, Optional, Tuple

from tierbench.metrics._trace_math import clipped, gaps

EPOCH = "repro_torch.sim.epoch"
#: host events that put work on the card: launches, copies, sets
RUNTIME_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")

Intervals = List[Tuple[float, float]]


def spans(trace, names: Iterable[str]) -> Intervals:
    """``(start, end)`` of the host events named in ``names``, clipped to
    the window."""
    names = set(names)
    return clipped(((s, e) for n, s, e in trace["host"] if n in names),
                   trace["window"])


def merged(intervals: Iterable[Tuple[float, float]]) -> Intervals:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: Intervals = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap_ns(a: Intervals, b: Intervals) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_pct(trace, names: Iterable[str]) -> Optional[float]:
    """Share (%) of the window in which the device was idle while the host
    was inside a span named in ``names``."""
    inside = spans(trace, names)
    if not trace["device"] or not inside:
        return None
    lo, hi = trace["window"]
    return 100.0 * overlap_ns(gaps(trace), merged(inside)) / (hi - lo)


def epoch_host_ms(trace) -> Optional[float]:
    """Median host duration of an epoch span, in ms."""
    epochs = spans(trace, [EPOCH])
    if not trace["device"] or not epochs:
        return None
    return median(e - s for s, e in epochs) / 1e6


def runtime_calls_per_epoch(trace, phase: str) -> Optional[float]:
    """CUDA runtime calls that start inside a ``phase`` span, per epoch
    span."""
    epochs = spans(trace, [EPOCH])
    if not trace["device"] or not epochs:
        return None
    inside = merged(spans(trace, [phase]))
    starts = [s for s, _ in inside]
    n = 0
    for name, s, _ in trace["host"]:
        if name.startswith(RUNTIME_CALLS):
            i = bisect_right(starts, s) - 1
            if i >= 0 and s < inside[i][1]:
                n += 1
    return n / len(epochs)
