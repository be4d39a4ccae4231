"""One run of one cell: set-up, the measured window (or the traced
stretch), the check of the results against the reference, the result.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names
the cell's configuration and traffic mix; ``configs/<config>.json`` names
its driver (``drivers/<driver>.py``); ``traffic/<mix>.json`` is read by
``generate.py``; ``limits/<cell>.json`` holds the limits of the numbers
compared; ``metrics/<metric>.py`` reads one per-layer metric from the
trace.  This file changes for none of them.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from . import load

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: whole passes the traced run profiles
TRACED_PASSES = 3
#: idle gaps and device operations the breakdown lists
BREAKDOWN_TOP = 10
#: characters of a kernel's name the breakdown keeps
NAME_CHARS = 120


class Refused(RuntimeError):
    """The run cannot measure: no card, too few cards, or a bad cell."""


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of ``BENCHMARK.json`` with its files."""

    def __init__(self, name: str, bench: Optional[Dict[str, Any]] = None):
        self.bench = bench or read_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise Refused(f"no cell {name!r} in BENCHMARK.json (cells: "
                          f"{sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.config = read_json(HERE / "configs"
                                / f"{self.entry['config']}.json")
        self.traffic = read_json(HERE / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.limits = read_json(HERE / "limits" / f"{name}.json")

    def metrics(self, kind: str) -> List[Dict[str, Any]]:
        """The cell's ``end_to_end`` or ``per_layer`` metrics: those whose
        ``workloads`` list it; an end-to-end metric without the list is
        every cell's, a per-layer metric has to list its cells."""
        if kind == "end_to_end":
            return [m for m in self.bench[kind]
                    if self.name in m.get("workloads", [self.name])]
        return [m for m in self.bench[kind] if self.name in m["workloads"]]


def check_device(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is False: the benchmark "
                      "measures the card and has no CPU mode")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, "
                      f"torch.cuda.device_count() is "
                      f"{torch.cuda.device_count()}")


def device_info(chips: int) -> Dict[str, Any]:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


# ---------------------------------------------------------------------------
# the traced stretch
# ---------------------------------------------------------------------------
def _events(prof):
    """(device, host) event lists ``(name, start_ns, end_ns)`` of a
    finished ``torch.profiler`` session."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() != DeviceType.CUDA:
            host.append(row)
        elif not e.is_user_annotation():  # a span's device-side copy
            device.append(row)
    return device, host


def traced_passes(driver, passes: int):
    """Profile ``passes`` whole passes; returns the trace readers get."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            with record_function("tierbench.pass"):
                driver.run_pass()
        torch.cuda.synchronize()
    dev, host = _events(prof)
    spans = [(s, e) for name, s, e in host if name == "tierbench.pass"]
    window = (min(s for s, _ in spans), max(e for _, e in spans))
    return {"device": dev, "host": host, "window": window,
            "shapes": driver.shapes()}


def breakdown_of(trace) -> Dict[str, List[List[Any]]]:
    """The device operations that took most time, and the longest idle
    gaps, each named by the innermost host event running at its middle."""
    tm = load("metrics", "_trace_math")
    lo, hi = trace["window"]
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in trace["device"]
              if min(e, hi) > max(s, lo)]
    ops = sorted(tm.time_by_name(inside).items(),
                 key=lambda kv: -kv[1])[:BREAKDOWN_TOP]
    host = sorted(trace["host"], key=lambda h: h[1])
    longest = sorted(tm.gaps(trace), key=lambda g: g[0] - g[1])
    idle = []
    for s, e in longest[:BREAKDOWN_TOP]:
        mid = (s + e) / 2
        inner = [h for h in host if h[1] <= mid < h[2]]
        name = max(inner, key=lambda h: h[1])[0] if inner else "(none)"
        idle.append([name, (e - s) / 1e9])
    return {"device_ops": [[n[:NAME_CHARS], t / 1e9] for n, t in ops],
            "idle_gaps": idle}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------
def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        t0: Optional[float] = None) -> Dict[str, Any]:
    """One run of ``cell_name`` on the card at the configuration's scale;
    returns the result line's object."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = Cell(cell_name)
    import torch  # noqa: F401  (timed apart from the card's start)
    marks = {"import torch": time.perf_counter()}
    check_device(cell.chips)
    marks["card"] = time.perf_counter()
    drv_mod = load("drivers", cell.config["driver"])
    driver = drv_mod.Driver(cell.config, cell.traffic, seed, "cuda")
    marks["program"] = time.perf_counter()
    return measure(cell, drv_mod, driver, seconds, trace, t0, marks)


def measure(cell: Cell, drv_mod, driver, seconds: float, trace: bool,
            t0: float, marks: Dict[str, float]) -> Dict[str, Any]:
    """Set-up's warm pass, the window or the traced stretch, and the
    check, of a built ``driver``.  ``marks`` holds the set-up's earlier
    steps, each by the clock reading at its end."""
    import torch
    driver.warm()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks["warm pass"] = time.perf_counter()
    setup_s = marks["warm pass"] - t0
    steps, last = [], t0
    for name, t in marks.items():
        steps.append(f"{name} {t - last:.3f}")
        last = t
    print(f"tierbench: set-up {setup_s:.3f} s: {', '.join(steps)} s",
          file=sys.stderr)

    metrics: Dict[str, Dict[str, Any]] = {}
    traced: Dict[str, Any] = {}
    breakdown = None
    if not trace:
        units, start, ends = 0, time.perf_counter(), []
        while not ends or ends[-1] - start < seconds:  # whole passes
            units += driver.run_pass()
            ends.append(time.perf_counter())
        took = [b - a for a, b in zip([start] + ends, ends)]
        print(f"tierbench: window {ends[-1] - start:.3f} s, {len(took)} "
              f"passes of {' '.join(f'{t:.3f}' for t in took)} s",
              file=sys.stderr)
        values = {"setup_s": setup_s,
                  drv_mod.RATE_METRIC: units / (ends[-1] - start)}
        for m in cell.metrics("end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        tr = traced_passes(driver, TRACED_PASSES)
        for m in cell.metrics("per_layer"):
            value = load("metrics", m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tm = load("metrics", "_trace_math")
        lo, hi = tr["window"]
        traced = {"busy_s": tm.busy_ns(tr) / 1e9, "window_s": (hi - lo) / 1e9}
        breakdown = breakdown_of(tr)
    dev = dict(device_info(cell.chips), **traced)
    attempted = sum(len(p["configs"]) for p in driver.passes)

    # the check: after the window, the peak read and the program freed
    driver.free()
    t_check = time.perf_counter()
    rows = driver.compare()
    print(f"tierbench: check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    limits = {name: lim["limit"]
              for name, lim in cell.limits["numbers"].items()}
    compared = {name: {"value": max(r[name] for r in rows), "limit": limit}
                for name, limit in limits.items()}
    failed = sum(any(r[name] > limit for name, limit in limits.items())
                 for r in rows)
    result = {"correct": failed == 0 and bool(rows), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result
