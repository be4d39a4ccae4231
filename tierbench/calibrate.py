"""The readings the limits of ``limits/<cell>.json`` are set from.

    python3 -m tierbench.calibrate --workload <cell> --seeds 12 \\
        --control-seeds 4 [--first-seed N]

For each seed, at the cell's own size and batch on the card: one set-up,
three whole passes, and the gaps of the judged configurations to
the float32 reference (the lower readings); on the first
``--control-seeds`` seeds also the gaps of the control, the reference
computed in bfloat16 in the program's place (the upper readings).  Prints
one JSON line per seed and a summary line with the largest program gap
and the smallest control gap of each number.  The benchmark's runs never
run this; it needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: whole passes per seed: as many as a run's check judges
PASSES = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=4)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 1001)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from tierbench import bench, load
    cell = bench.Cell(args.workload)
    bench.check_device(cell.chips)
    drv_mod = load("drivers", cell.config["driver"])
    lower, upper = {}, {}
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        t = time.perf_counter()
        driver = drv_mod.Driver(cell.config, cell.traffic, seed, "cuda")
        driver.warm()
        for _ in range(PASSES):
            driver.run_pass()
        driver.free()
        row = {"seed": seed, "program": _widest(driver.compare())}
        if k < args.control_seeds:
            row["control"] = _widest(driver.control())
        row["seconds"] = time.perf_counter() - t
        for name, v in row["program"].items():
            lower[name] = max(lower.get(name, 0.0), v)
        for name, v in row.get("control", {}).items():
            upper[name] = min(upper.get(name, float("inf")), v)
        print(json.dumps(row), flush=True)
    print(json.dumps({"cell": args.workload, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


def _widest(rows):
    return {name: max(r[name] for r in rows) for name in rows[0]}


if __name__ == "__main__":
    sys.exit(main())
