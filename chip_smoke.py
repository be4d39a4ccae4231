#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

Run from the root of a checkout with one CUDA card:

    python3 chip_smoke.py

It imports only ``torch``, numpy and the port (``src/repro_torch``), and
runs, in order (any failure exits non-zero and prints no result):

1. the card's name and power limit, then the build of every CUDA kernel
   from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, started
   together);
2. ``select_topk`` against its plain PyTorch version on the card: the
   conformance corpus (heavy ties, k in {0, 1, n}, ulp-apart non-ties,
   empty rows) and the main path's shape (8, 32783) with heats from a
   HeMem epoch; masks must be bitwise equal.  Then CUDA-event times
   (median of 30 after warm-up) of the kernel, the plain version and a
   ``torch.topk`` yardstick;
3. the port against its own CPU path on a small input (gups at scale
   0.02): deterministic engines bitwise on migrations, sampled ones within
   the cross-device float tolerance;
4. ``Study.run`` for each engine on the paper's GUPS deployment (gups
   8GiB-hot at scale 1.0: 32,783 pages, 60 epochs) on ``pmem-large``,
   B = 8, ``crn=True``: bitwise equal to the same run with the plain
   selection, bitwise equal on a rerun, identical rows for identical
   configs, and 60 kernel launches per planning engine;
5. the main path: ``Study.tune`` (hemem, budget 16, batch 8, crn) with the
   launch counters set to 0 just before and read just after;
6. one JSON line per the kernel table, the card line again, and as the
   last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: H100 SXM device-memory rate (bytes/s), NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12
SCALE, EPOCHS, BATCH = 1.0, 60, 8
PLANNING = ("hemem", "memtis", "hmsdk", "oracle")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def gups_study(engine, device="cuda", scale=SCALE, **opts):
    from repro_torch.core import ExperimentSpec, SimOptions, Study, WorkloadSpec
    return Study(ExperimentSpec(
        engine=engine, workload=WorkloadSpec("gups", "8GiB-hot", scale=scale),
        machine="pmem-large",
        options=SimOptions(seed=0, crn=True, device=device, **opts)))


def batch_configs(engine):
    """Default config plus 7 seeded random ones (empty for knob-less)."""
    import numpy as np
    from repro_torch.core.knobs import SPACES
    space = SPACES.get(engine)
    if space is None:
        return [{} for _ in range(BATCH)]
    rng = np.random.default_rng(1234)
    return [space.default_config()] + [space.sample(rng)
                                       for _ in range(BATCH - 1)]


def corpus(device):
    """(name, args) cases of the conformance corpus plus the edges."""
    import numpy as np
    import torch
    rng = np.random.default_rng(7)
    B, n = 3, 256
    cases = []
    for levels in (0, 2, 3, 17, 255):
        for density in (0.05, 0.5, 0.95):
            if levels:
                ph = rng.integers(0, levels, (B, n)).astype(np.float32)
                dh = rng.integers(0, levels, (B, n)).astype(np.float32)
            else:
                ph = rng.uniform(0, 1e6, (B, n)).astype(np.float32)
                dh = rng.uniform(0, 1e6, (B, n)).astype(np.float32)
            pm = rng.uniform(size=(B, n)) < density
            dm = rng.uniform(size=(B, n)) < density
            edges = [0, 1, n, int(rng.integers(0, n + 1))]
            kp = np.array([edges[b % 4] for b in range(B)], np.float32)
            kd = np.array([edges[(b + 1) % 4] for b in range(B)], np.float32)
            cases.append((f"levels={levels},density={density}",
                          (pm, ph, dm, dh, kp, kd)))
    ones = np.ones((B, n), bool)
    tied = np.full((B, n), 7.0, np.float32)
    k3 = np.array([0, 1, 13], np.float32)
    cases.append(("all tied", (ones, tied, ones, tied, k3, k3)))
    base = np.float32(1000.0)
    up = np.nextafter(base, np.float32(np.inf), dtype=np.float32)
    ulp = np.tile(np.array([base, up] * (n // 2), np.float32), (B, 1))
    half = np.full(B, n // 2, np.float32)
    cases.append(("ulp-apart", (ones, ulp, ones, ulp, half, half)))
    zero = np.zeros((B, n), bool)
    cases.append(("empty rows", (zero, tied, zero, tied, half, half)))
    big = (rng.uniform(size=(2, 65535)) < 0.3,
           rng.integers(0, 9, (2, 65535)).astype(np.float32),
           rng.uniform(size=(2, 65535)) < 0.6,
           rng.uniform(-5, 5, (2, 65535)).astype(np.float32),
           np.array([65535, 1234], np.float32),
           np.array([30000, 0], np.float32))
    cases.append(("n=65535", big))
    return [(name, [torch.from_numpy(np.asarray(a)).to(device) for a in args])
            for name, args in cases]


def capture_hemem_epoch():
    """The select_topk inputs of one HeMem epoch at the main path's shape
    (the epoch with the most pages to select), taken from a plain run."""
    from repro_torch.core import engine_torch
    from repro_torch.kernels import ops
    best = []
    orig = ops.select_topk

    def record(*args):
        k = float(args[4].sum() + args[5].sum())
        if not best or k > best[0]:
            best[:] = [k, [a.clone() for a in args]]
        return orig(*args)

    ops.FORCE = "plain"
    engine_torch.kernel_ops.select_topk = record
    try:
        study = gups_study("hemem")
        study.run(configs=batch_configs("hemem"))
    finally:
        engine_torch.kernel_ops.select_topk = orig
        ops.FORCE = None
    return best[1]


def phase_select_topk(device):
    import torch
    from repro_torch.kernels import ops, ref, select_topk as sk
    max_err = 0
    cases = corpus(device)
    cases.append(("main path (8, 32783), hemem epoch", capture_hemem_epoch()))
    for name, args in cases:
        pm, dm = ops.select_topk(*args)
        rpm, rdm = ref.select_topk_ref(*args)
        torch.cuda.synchronize()
        err = max(int((pm != rpm).sum()), int((dm != rdm).sum()))
        max_err = max(max_err, err)
        if err:
            fail(f"select_topk differs from its plain version on {name}")
    print(f"select_topk: {len(cases)} cases bitwise equal to the plain "
          f"version", flush=True)
    args = [a.contiguous() for a in cases[-1][1]]
    args = [args[0].bool(), args[1].float(), args[2].bool(), args[3].float(),
            args[4].float(), args[5].float()]
    B, n = args[0].shape
    kernel_ms = cuda_ms(lambda: sk.select_topk(*args))
    plain_ms = cuda_ms(lambda: ref.select_topk_ref(*args))
    # yardstick: one torch.topk over unique packed (key, -index) words
    vp, vd = ref.pack_keys(*args[:4])
    idx = torch.arange(n, device=device, dtype=torch.int64)
    packed = torch.cat([vp, vd]) << 17 | (n - idx)[None, :]
    kmax = max(1, int(torch.cat([args[4], args[5]]).max()))
    library_ms = cuda_ms(lambda: torch.topk(packed, kmax, dim=-1))
    moved = B * n * (1 + 4 + 1 + 4) + 2 * B * 4 + 2 * B * n
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"select_topk at (B={B}, n={n}): kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.topk {library_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({moved} bytes)", flush=True)
    return {"max_abs_err": max_err, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms}


def phase_small_reference():
    """The card against the port's CPU path on a small input."""
    import numpy as np
    for engine in ("static", "oracle", "hemem", "hmsdk"):
        cfgs = batch_configs(engine)[:4]
        on_card = gups_study(engine, scale=0.02).run(configs=cfgs)
        on_cpu = gups_study(engine, "cpu", scale=0.02).run(configs=cfgs)
        for a, b in zip(on_card, on_cpu):
            if not (np.isfinite(a.epoch_wall_ms).all()
                    and a.epoch_wall_ms.shape == (EPOCHS,)):
                fail(f"{engine}: non-finite or misshapen walls")
            if engine in ("static", "oracle"):
                if not np.array_equal(a.cum_migrations, b.cum_migrations):
                    fail(f"{engine}: migrations differ from the CPU path")
                if not np.allclose(a.epoch_wall_ms, b.epoch_wall_ms,
                                   rtol=1e-5, atol=0):
                    fail(f"{engine}: walls differ from the CPU path")
            else:
                mig = abs(a.cum_migrations[-1] - b.cum_migrations[-1]) \
                    / max(b.cum_migrations[-1], 1.0)
                if mig > 0.01 or abs(a.total_s - b.total_s) > 1e-3 * b.total_s:
                    fail(f"{engine}: card and CPU path disagree")
    print("small input (gups, scale 0.02): card agrees with the CPU path",
          flush=True)


def phase_study_run():
    import numpy as np
    from repro_torch.kernels import ops
    for engine in PLANNING + ("static",):
        study = gups_study(engine)
        cfgs = batch_configs(engine)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = study.run(configs=cfgs)
        wall_s = time.perf_counter() - t0
        launches = ops.launch_counts()["select_topk"]
        want = EPOCHS if engine in PLANNING else 0
        if launches != want:
            fail(f"{engine}: {launches} select_topk launches, expected {want}")
        n_pages = study.workload().n_pages
        for r in res:
            if not (r.epoch_wall_ms.shape == (EPOCHS,)
                    and np.isfinite(r.epoch_wall_ms).all() and r.total_s > 0):
                fail(f"{engine}: non-finite or misshapen result")
        again = study.run(configs=cfgs)
        ops.FORCE = "plain"
        try:
            plain = study.run(configs=cfgs)
        finally:
            ops.FORCE = None
        for name, other in (("rerun", again), ("plain selection", plain)):
            for a, b in zip(res, other):
                if not (np.array_equal(a.epoch_wall_ms, b.epoch_wall_ms)
                        and np.array_equal(a.cum_migrations,
                                           b.cum_migrations)):
                    fail(f"{engine}: {name} is not bitwise equal")
        dup = study.run(configs=cfgs[:4] * 2)
        for i in range(4):
            if not (np.array_equal(dup[i].epoch_wall_ms,
                                   dup[i + 4].epoch_wall_ms)
                    and np.array_equal(dup[i].cum_migrations,
                                       dup[i + 4].cum_migrations)):
                fail(f"{engine}: identical configs differ under CRN")
        print(f"Study.run {engine}: n_pages={n_pages}, B={BATCH}, "
              f"{launches} launches, wall {wall_s:.3f} s, default total_s "
              f"{res[0].total_s:.4f}, migrations "
              f"{int(res[0].cum_migrations[-1])}", flush=True)


def phase_tune():
    import numpy as np
    from repro_torch.kernels import ops
    study = gups_study("hemem")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = study.tune(budget=16, batch_size=BATCH, seed=0)
    wall_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    # one default evaluation plus two rounds of 8, each a 60-epoch run
    if launches["select_topk"] != 3 * EPOCHS:
        fail(f"Study.tune: {launches} launches, expected {3 * EPOCHS}")
    if len(result.history) != 16 or not np.isfinite(result.best_value):
        fail("Study.tune: incomplete or non-finite history")
    print(f"Study.tune hemem: incumbent total_s {result.best_value:.4f}, "
          f"default total_s {result.default_value:.4f}, tuning wall "
          f"{wall_s:.3f} s", flush=True)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import select_topk as sk

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    seconds = build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(seconds)}", flush=True)

    timing = phase_select_topk("cuda")
    phase_small_reference()
    phase_study_run()
    launches = phase_tune()

    kernels = [{
        "name": "select_topk", "route": "cuda", "source": sk.SOURCE,
        "replaces": sk.REPLACES, "launches": launches["select_topk"],
        "max_abs_err": timing["max_abs_err"], "matches_plain": True,
        "ms": timing["kernel_ms"], "kernel_ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": "bytes", "library_ms": timing["library_ms"]}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
