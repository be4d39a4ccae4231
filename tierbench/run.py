"""Run one cell of the benchmark once and print its result line.

    python3 -m tierbench.run --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout.  ``--trace 0`` measures the cell's
end-to-end metrics over a window of ``--seconds``; ``--trace 1`` profiles
a few whole passes and reports the per-layer metrics instead.  Either
way the results are then checked against the plain reference, each
number compared is printed beside its limit on standard error, and the
last line of standard output is the result's JSON object.  Without a CUDA
card, or with fewer than the cell asks for, the run prints no result and
exits with 3; if the JAX package or JAX was loaded, with 4.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules the process that prints the result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (the loaded ones by
    default), compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from tierbench import bench
    try:
        result = bench.run(args.workload, args.seed, args.seconds,
                           bool(args.trace), t0=t0)
    except bench.Refused as e:
        print(f"tierbench: {e}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"tierbench: the process holds {found}; the benchmark "
              "measures the PyTorch port alone", file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
