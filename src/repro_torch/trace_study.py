"""Where the time of one ``Study.run`` goes on the card.

    PYTHONPATH=src python -m repro_torch.trace_study [--engines hemem,oracle]
        [--scale 1.0] [--batch 8] [--out DIR]

For each engine (gups 8GiB-hot on pmem-large, ``crn=True``): one warm-up
run, one timed run (host clock ended by ``torch.cuda.synchronize``), and one
run under ``torch.profiler``.  Prints per engine one JSON line with the
timed run's wall seconds, the profiled run's device-busy seconds (the union
of CUDA kernel and copy intervals), the idle share (1 - busy / timed
wall), device launches per
epoch, ``select_topk``'s share of device time, and the ten kernels with the
most device time; with ``--out``, writes a Chrome trace per engine there
(tens of MB each).  Needs
a CUDA card: it measures the card and has no CPU mode.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path


def _busy_us(intervals):
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


def trace_engine(engine, scale, batch, out_dir):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .core import ExperimentSpec, SimOptions, Study, WorkloadSpec
    from .core.knobs import SPACES

    space = SPACES.get(engine)
    rng = np.random.default_rng(1234)
    cfgs = [{} for _ in range(batch)] if space is None else \
        [space.default_config()] + [space.sample(rng)
                                    for _ in range(batch - 1)]
    study = Study(ExperimentSpec(
        engine=engine, workload=WorkloadSpec("gups", "8GiB-hot", scale=scale),
        options=SimOptions(seed=0, crn=True, device="cuda")))
    study.run(configs=cfgs)  # warm-up: kernel build, allocator, caches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    study.run(configs=cfgs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        study.run(configs=cfgs)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    epochs = study.workload().n_epochs
    row = {"engine": engine, "n_pages": study.workload().n_pages,
           "batch": batch, "epochs": epochs, "wall_s": wall_s}
    if not events:
        row["device"] = "not measured (the profiler saw no device events)"
    else:
        span = (max(e.time_range.end for e in events)
                - min(e.time_range.start for e in events))
        busy = _busy_us((e.time_range.start, e.time_range.end)
                        for e in events)
        by_name = collections.Counter()
        for e in events:
            by_name[e.name] += e.time_range.end - e.time_range.start
        sel = sum(t for name, t in by_name.items() if "select_topk" in name)
        row.update({
            "profiled_span_s": span / 1e6, "device_busy_s": busy / 1e6,
            # against the unprofiled run's wall: the profiler slows the host
            "idle_share": max(0.0, 1.0 - busy / 1e6 / wall_s),
            "launches_per_epoch": len(events) / epochs,
            "select_topk_share": sel / max(sum(by_name.values()), 1e-9),
            "top_kernels_ms": {name[:80]: t / 1e3 for name, t
                               in by_name.most_common(10)}})
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out_dir / f"{engine}.json"))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engines", default="hemem,memtis,hmsdk,oracle,static")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="directory for one Chrome trace per engine")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("trace_study: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    for engine in args.engines.split(","):
        row = trace_engine(engine, args.scale, args.batch,
                           Path(args.out) if args.out else None)
        row["card"] = card
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
