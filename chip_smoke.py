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
5. the main path of the tuning loop: ``Study.tune`` (hemem, budget 16,
   batch 8, crn) with the launch counters set to 0 just before and read
   just after;
6. ``page_migrate`` against its plain version, bitwise: bf16 and f32, -1
   lanes (the row-0 case included), duplicate destinations, no lanes, rows
   that are not a multiple of 16 bytes, and the serving shape (256 lanes of
   917,504-byte rows); CUDA-event times of the kernel, the plain version
   and ``index_select`` + ``index_copy_`` at the serving shape;
7. ``paged_attention`` against its plain version (f32 within 1e-5, bf16
   within 1e-2): G in {1, 16}, lengths 0, partial and full, -1 table
   entries, the strided layer-0 view; times at the serving shape beside
   ``scaled_dot_product_attention`` on the resident K/V gathered into a
   dense tensor (the gather not timed);
8. the main path of serving: ``replay`` at chatglm3-6b's KV width (28
   layers, 2 KV heads of 128, 32 query heads, bf16, 64-token pages), 64
   sequence slots of 32 pages, 256 HBM pages, 1,024 steps of
   bursty-diurnal traffic, an engine epoch every 8 steps, with the launch
   counters set to 0 just before and read just after (paged_attention once
   per decoded step, page_migrate 4 and select_topk 1 per epoch); a rerun
   bitwise equal in residency, migrations and outputs; ``FORCE="plain"``
   bitwise equal in residency and migrations, outputs within 1e-2; decode
   ms per step timed in turns (kernels, plain, plain, kernels); then a
   profiled 256-step replay for each kernel's share of device time;
9. a small spec on the card and on the port's CPU path: residency and
   migrations bitwise;
10. ``Study.run`` of kv-hemem on kv-poisson on the card, within the
    cross-device tolerance of the CPU path;
11. the serving tuning loop: ``Study.tune(budget=8, objective=serving
    objective)`` over 256-step replays at the same width;
12. one JSON line per the kernel table, the card line again, and as the
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


# ---------------------------------------------------------------------------
# tiered-KV serving
# ---------------------------------------------------------------------------
#: the serving main path: chatglm3-6b's KV width, 64 slots x 32 pages of
#: 64 tokens (2,048 logical pages), 256 HBM pages (1/8), 1,024 steps
SERVING = dict(model="chatglm3-6b", batch=64, max_pages=32, hbm_frac=1 / 8,
               steps=1024, tune_steps=256, profile_steps=256, decode_lo=256,
               decode_hi=1024, engine_every=8, dt_ms=50.0, tune_budget=8)


def serving_traffic(steps):
    from repro_torch.core.traffic import TrafficSpec
    b = SERVING["batch"]
    # the repo's arrival rule: batch / 24 requests per step
    return TrafficSpec(pattern="bursty-diurnal", arrival_rate=b / 24,
                       steps=steps, decode_lo=SERVING["decode_lo"],
                       decode_hi=SERVING["decode_hi"])


def serving_replay(config, steps, device="cuda", **kw):
    from repro_torch.core.tiered_kv import KV_MODELS
    from repro_torch.serving_replay import replay
    model = KV_MODELS[SERVING["model"]]
    return replay(config, serving_traffic(steps), batch=SERVING["batch"],
                  max_pages=SERVING["max_pages"],
                  hbm_frac=SERVING["hbm_frac"],
                  engine_every=SERVING["engine_every"],
                  dt_ms=SERVING["dt_ms"], spec=model.spec,
                  q_heads=model.q_heads, device=device, **kw)


def expected_serving_launches(steps):
    """Launches the replay must make: paged_attention once per step with an
    active sequence; per engine epoch page_migrate 4 and select_topk 1."""
    from repro_torch.core.traffic import replay_schedule
    b, mp = SERVING["batch"], SERVING["max_pages"]
    from repro_torch.core.tiered_kv import KV_MODELS
    pt = KV_MODELS[SERVING["model"]].spec.page_tokens
    sched = replay_schedule(serving_traffic(steps), b, mp * pt, 0)
    decoded = sched["active"].any(axis=1)
    every = SERVING["engine_every"]
    epochs = int(sum(decoded[t] for t in range(steps)
                     if t % every == every - 1))
    return {"paged_attention": int(decoded.sum()),
            "page_migrate": 4 * epochs, "select_topk": epochs}


def migrate_cases(device):
    """(name, dst, src, dst_ids, src_ids) cases of the conformance set."""
    import numpy as np
    import torch
    rng = np.random.default_rng(11)
    cases = []

    def pools(P, Q, elems, dtype):
        return (torch.from_numpy(rng.normal(size=(P, elems))).to(device, dtype),
                torch.from_numpy(rng.normal(size=(Q, elems))).to(device, dtype))

    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        ids = [("row-0 no-op", 6, 6, 64, [0, -1], [2, 1]),
               ("duplicates", 6, 8, 64, [2, 3, 2, 5, -1, 2], [1, 0, 4, 4, 3, 7]),
               ("no lanes", 4, 4, 64, [], []),
               ("rows of 7 elements", 5, 5, 7, [1, 4, 0, -1], [3, 3, 2, 0]),
               ("misaligned rows", 9, 9, 4099, [8, 0, 3, 3], [0, 8, -1, 5])]
        for name, P, Q, elems, d, s_ in ids:
            dst, src = pools(P, Q, elems, dtype)
            cases.append((f"{name} ({tag})", dst, src,
                          torch.tensor(d, dtype=torch.int32, device=device),
                          torch.tensor(s_, dtype=torch.int32, device=device)))
        P, Q, elems = 300, 400, 4096
        dst, src = pools(P, Q, elems, dtype)
        d = torch.from_numpy(rng.integers(-1, P, 512).astype(np.int32))
        s_ = torch.from_numpy(rng.integers(-1, Q, 512).astype(np.int32))
        cases.append((f"random 512 lanes ({tag})", dst, src, d.to(device),
                      s_.to(device)))
    return cases


def serving_migrate_args(device):
    """The serving shape: promote 256 pages of chatglm3-6b's KV width from
    the host pool (2,049 rows) into the HBM pool (257 rows), every lane
    valid."""
    import torch
    from repro_torch.core.tiered_kv import KV_MODELS
    spec = KV_MODELS[SERVING["model"]].spec
    elems = spec.n_layers * spec.page_tokens * spec.kv_heads * spec.head_dim
    n = SERVING["batch"] * SERVING["max_pages"]
    H = int(n * SERVING["hbm_frac"])
    g = torch.Generator(device=device).manual_seed(3)
    dst = torch.randn((H + 1, elems), generator=g, device=device
                      ).to(spec.dtype)
    src = torch.randn((n + 1, elems), generator=g, device=device
                      ).to(spec.dtype)
    d = torch.randperm(H, generator=g, device=device).int()
    s = torch.randperm(n, generator=g, device=device)[:H].int()
    return dst, src, d, s


def phase_page_migrate():
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import page_migrate as pmk
    cases = migrate_cases("cuda")
    cases.append(("serving shape", *serving_migrate_args("cuda")))
    for name, dst, src, d, s in cases:
        want = ref.page_migrate_plain(dst.clone(), src, d, s)
        got = ops.page_migrate(dst, src, d, s)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"page_migrate differs from its plain version on {name}")
    print(f"page_migrate: {len(cases)} cases bitwise equal to the plain "
          f"version", flush=True)
    dst, src, d, s = cases[-1][1:]
    dl, sl = d.long(), s.long()
    kernel_ms = cuda_ms(lambda: pmk.page_migrate(dst, src, d, s))
    plain_ms = cuda_ms(lambda: ref.page_migrate_plain(dst, src, d, s))
    library_ms = cuda_ms(lambda: dst.index_copy_(0, dl, src.index_select(0, sl)))
    moved = 2 * d.numel() * dst[0].numel() * dst.element_size()
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"page_migrate at the serving shape ({d.numel()} lanes of "
          f"{dst[0].numel() * dst.element_size()} B): kernel {kernel_ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, index_select+index_copy_ "
          f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({moved} bytes)",
          flush=True)
    return {"max_abs_err": 0.0, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms}


def attention_case(device, dtype, B, H, KV, D, page, ppseq, P, layers, seed):
    """q, layer-0 views of (P, layers, page, KV, D) pools, a block table
    with -1 entries, and lengths 0 (row 0), full (last row), partial (row
    1) and random."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, H, D))).to(device, dtype)
    k = torch.from_numpy(rng.normal(size=(P, layers, page, KV, D))).to(device, dtype)
    v = torch.from_numpy(rng.normal(size=(P, layers, page, KV, D))).to(device, dtype)
    table = np.stack([rng.choice(P, ppseq, replace=False) for _ in range(B)])
    table = np.where(rng.uniform(size=table.shape) < 0.25, -1, table)
    lengths = rng.integers(0, page * ppseq + 1, B)
    lengths[0] = 0
    lengths[-1] = page * ppseq
    if B > 2:
        lengths[1] = page // 2 + 1
    return (q, k[:, 0], v[:, 0],
            torch.from_numpy(table.astype(np.int32)).to(device),
            torch.from_numpy(lengths.astype(np.int32)).to(device))


def serving_attention_args(device):
    """The serving shape: q (64, 32, 128) bf16 over the layer-0 view of a
    (257, 28, 64, 2, 128) HBM pool; the 256 slots spread 4 per sequence
    over pages below its length, the rest of the table -1."""
    import numpy as np
    import torch
    from repro_torch.core.tiered_kv import KV_MODELS
    model = KV_MODELS[SERVING["model"]]
    spec = model.spec
    B, mp = SERVING["batch"], SERVING["max_pages"]
    H = int(B * mp * SERVING["hbm_frac"])
    rng = np.random.default_rng(5)
    g = torch.Generator(device=device).manual_seed(5)
    shape = (H + 1, spec.n_layers, spec.page_tokens, spec.kv_heads,
             spec.head_dim)
    pool_k = torch.randn(shape, generator=g, device=device).to(spec.dtype)
    pool_v = torch.randn(shape, generator=g, device=device).to(spec.dtype)
    q = torch.randn((B, model.q_heads, spec.head_dim), generator=g,
                    device=device).to(spec.dtype)
    lengths = rng.integers(4 * spec.page_tokens, mp * spec.page_tokens + 1, B)
    table = np.full((B, mp), -1, np.int32)
    slots = rng.permutation(H)
    per = H // B
    for b in range(B):
        n_p = (lengths[b] - 1) // spec.page_tokens + 1
        pages = rng.choice(n_p, per, replace=False)
        table[b, pages] = slots[b * per:(b + 1) * per]
    return (q, pool_k[:, 0], pool_v[:, 0], torch.from_numpy(table).to(device),
            torch.from_numpy(lengths.astype(np.int32)).to(device))


def attended_positions(table, lengths, page):
    """Resident positions each sequence attends: (B,) int64 on the host."""
    import torch
    t = table.cpu().long()
    ln = lengths.cpu().long()
    pos = torch.arange(t.shape[1] * page)
    ok = (pos[None, :] < ln[:, None]) & (t[:, pos // page] >= 0)
    return ok, ok.sum(1)


def phase_paged_attention():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pak
    max_err = 0.0
    n = 0
    shapes = [  # B, H, KV, D, page, ppseq, P, layers
        (2, 8, 4, 64, 16, 4, 16, 1), (3, 4, 1, 128, 8, 8, 64, 1),
        (4, 2, 2, 128, 64, 4, 24, 3), (8, 32, 2, 128, 64, 8, 40, 3)]
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for shape in shapes:
            for cap in (0.0, 30.0):
                args = attention_case("cuda", dtype, *shape, seed=n)
                want = ref.paged_attention_plain(*args, logit_softcap=cap)
                got = ops.paged_attention(*args, logit_softcap=cap)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                if dtype == torch.bfloat16:
                    max_err = max(max_err, err)
                if not torch.allclose(got.float(), want.float(), atol=tol,
                                      rtol=tol):
                    fail(f"paged_attention differs from its plain version "
                         f"({dtype}, shape {shape}, cap {cap}): {err}")
                n += 1
    args = serving_attention_args("cuda")
    want = ref.paged_attention_plain(*args)
    got = ops.paged_attention(*args)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    max_err = max(max_err, err)
    if not torch.allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2):
        fail(f"paged_attention differs from its plain version at the "
             f"serving shape: {err}")
    print(f"paged_attention: {n + 1} cases within tolerance of the plain "
          f"version (max bf16 abs err {max_err:.3g})", flush=True)
    q, k, v, table, lengths = args
    kernel_ms = cuda_ms(lambda: pak.paged_attention(q, k, v, table, lengths))
    plain_ms = cuda_ms(lambda: ref.paged_attention_plain(q, k, v, table,
                                                         lengths))
    # yardstick: SDPA over the resident K/V, gathered (not timed) into a
    # dense (B, H, T, D) tensor padded to the longest row, with a mask
    B, Hq, D = q.shape
    page, KV = k.shape[1], k.shape[2]
    ok, per_seq = attended_positions(table, lengths, page)
    T = int(per_seq.max())
    idx = torch.zeros((B, T), dtype=torch.long)
    mask = torch.zeros((B, T), dtype=torch.bool)
    for b in range(B):
        p = torch.nonzero(ok[b]).flatten()
        idx[b, :p.numel()] = p
        mask[b, :p.numel()] = True
    tbl = table.cpu().long()
    slot = tbl.gather(1, idx // page).clamp(min=0)
    kd = k[slot.to(q.device), (idx % page).to(q.device)]   # (B, T, KV, D)
    vd = v[slot.to(q.device), (idx % page).to(q.device)]
    G = Hq // KV
    kd = kd.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    vd = vd.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    qd = q[:, :, None, :]
    am = mask.to(q.device)[:, None, None, :]
    lib = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=am)[:, :, 0]
    if not torch.allclose(lib.float(), got.float(), atol=2e-2, rtol=2e-2):
        fail("the SDPA yardstick does not compute the kernel's function")
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=am))
    elt = q.element_size()
    moved = 2 * int(per_seq.sum()) * KV * D * elt + 2 * q.numel() * elt
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"paged_attention at the serving shape (B={B}, H={Hq}, KV={KV}, "
          f"D={D}, {int(per_seq.sum())} resident positions): kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA on gathered "
          f"K/V {library_ms:.4f} ms, bound {bound_ms:.5f} ms ({moved} bytes)",
          flush=True)
    return {"max_abs_err": max_err, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms}


def profile_serving(steps):
    """Device time by kernel over a profiled replay: the share of each of
    the port's kernels and the device's busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        serving_replay(None, steps)
        wall_ms = (time.perf_counter() - t0) * 1e3
    names = {"paged_attention": "paged_attention_kernel",
             "page_migrate": ("page_migrate_copy", "page_migrate_winner"),
             "select_topk": "select_topk_kernel"}
    per = {k: 0.0 for k in names}
    busy_us = 0.0
    launches = 0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy_us += us
        launches += e.count
        rows.append((us, e.key[:80], e.count))
        for k, pat in names.items():
            pats = pat if isinstance(pat, tuple) else (pat,)
            if any(p in e.key for p in pats):
                per[k] += us
    rows.sort(reverse=True)
    out = {"steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
           "device_launches": launches,
           "kernel_ms": {k: v / 1e3 for k, v in per.items()},
           "top": [{"name": n, "ms": us / 1e3, "count": c}
                   for us, n, c in rows[:6]]}
    print("serving device time (profiled replay): " + json.dumps(out),
          flush=True)
    return out


def phase_serving():
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    steps = SERVING["steps"]
    want = expected_serving_launches(steps)
    # warm-up (first-use allocation of the pools and op dispatch), so the
    # timed turns below start alike; its launches are reset away
    serving_replay(None, 64)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serving_replay(None, steps, record=True)
    launches = ops.launch_counts()
    if launches != want:
        fail(f"serving replay launches {launches}, expected {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if res["migrations"] <= 0:
        fail("serving replay made no migrations")
    out = res["outputs"]
    if not (torch.isfinite(out.float()).all() and out.shape[1:] == (
            SERVING["batch"], 32, 128)):
        fail("serving outputs non-finite or misshapen")
    again = serving_replay(None, steps, record=True)
    if not (np.array_equal(res["epoch_slots"], again["epoch_slots"])
            and res["migrations"] == again["migrations"]
            and torch.equal(res["outputs"], again["outputs"])):
        fail("serving rerun is not bitwise equal")
    ops.FORCE = "plain"
    try:
        plain = serving_replay(None, steps, record=True)
        plain2 = serving_replay(None, steps)
    finally:
        ops.FORCE = None
    again2 = serving_replay(None, steps)
    # decode ms per step in turns: kernels, plain, plain, kernels (the
    # first and second replays are also the rerun check)
    turns = [r["decode_ms_per_step"] for r in (res, plain, plain2, again2)]
    del again, plain2, again2
    if not (np.array_equal(res["epoch_slots"], plain["epoch_slots"])
            and res["migrations"] == plain["migrations"]):
        fail("serving with the plain versions differs in residency or "
             "migrations")
    err = float((res["outputs"].float() - plain["outputs"].float()).abs().max())
    if not torch.allclose(res["outputs"].float(), plain["outputs"].float(),
                          atol=1e-2, rtol=1e-2):
        fail(f"serving outputs differ from the plain versions by {err}")
    stats = {k: res[k] for k in ("steps", "tokens", "decode_ms_per_step",
                                 "tokens_per_s", "p50_ms", "p99_ms", "recall",
                                 "migrations", "completed", "wall_s")}
    stats.update(decode_ms_per_step_turns=dict(zip(
                     ("kernels", "plain", "plain_again", "kernels_again"),
                     turns)),
                 plain_wall_s=plain["wall_s"], peak_gb=peak_gb,
                 outputs_max_abs_err_vs_plain=err)
    print("serving replay (chatglm3-6b KV width, 64 x 32 pages, 256 in "
          "HBM): " + json.dumps(stats), flush=True)
    del res, plain
    torch.cuda.empty_cache()
    profile = profile_serving(SERVING["profile_steps"])
    return launches, stats, profile


def phase_serving_small():
    """The port's fused serving on the card against its CPU path."""
    import numpy as np
    import torch
    from repro_torch.core.tiered_kv import KVSpec
    from repro_torch.core.traffic import TrafficSpec
    from repro_torch.serving_replay import replay
    spec = KVSpec(n_layers=2, kv_heads=2, head_dim=8, page_tokens=8,
                  dtype=torch.bfloat16)
    traffic = TrafficSpec(pattern="bursty-diurnal", arrival_rate=8 / 24,
                          steps=160, decode_lo=16, decode_hi=60)
    corners = [None,
               dict(read_hot_threshold=1, sampling_period=100,
                    migration_period=10),
               dict(read_hot_threshold=2, write_hot_threshold=1,
                    cooling_threshold=4, cooling_pages=1024,
                    migration_period=10)]
    for cfg in corners:
        runs = [replay(cfg, traffic, batch=8, max_pages=8, spec=spec,
                       q_heads=8, device=dev, record=True)
                for dev in ("cuda", "cpu")]
        a, b = runs
        if not (np.array_equal(a["epoch_slots"], b["epoch_slots"])
                and a["migrations"] == b["migrations"]):
            fail(f"small spec {cfg}: card and CPU differ in residency or "
                 f"migrations")
        if not torch.allclose(a["outputs"].cpu().float(),
                              b["outputs"].float(), atol=1e-2, rtol=1e-2):
            fail(f"small spec {cfg}: card and CPU outputs differ")
    print(f"small spec: {len(corners)} configs, residency and migrations "
          f"bitwise equal on the card and the CPU", flush=True)


def phase_kv_study():
    import numpy as np
    from repro_torch.core import ExperimentSpec, SimOptions, Study

    def run(device):
        return Study(ExperimentSpec(engine="kv-hemem", workload="kv-poisson",
                                    options=SimOptions(device=device))).run()
    card, cpu = run("cuda"), run("cpu")
    if not (np.isfinite(card.epoch_wall_ms).all() and card.total_s > 0):
        fail("Study.run kv-hemem: non-finite result")
    mig = abs(card.cum_migrations[-1] - cpu.cum_migrations[-1]) \
        / max(cpu.cum_migrations[-1], 1.0)
    if mig > 0.01 or abs(card.total_s - cpu.total_s) > 1e-3 * cpu.total_s:
        fail("Study.run kv-hemem: card and CPU path disagree")
    print(f"Study.run kv-hemem/kv-poisson: total_s {card.total_s:.4f} "
          f"(CPU path {cpu.total_s:.4f}), migrations "
          f"{int(card.cum_migrations[-1])}", flush=True)


def phase_serving_tune():
    import numpy as np
    from repro_torch.core import ExperimentSpec, Study
    from repro_torch.serving_replay import serving_objective
    steps = SERVING["tune_steps"]

    def objective(config):
        return serving_objective(serving_replay(config, steps))

    study = Study(ExperimentSpec(engine="kv-hemem", workload="kv-poisson"))
    t0 = time.perf_counter()
    result = study.tune(budget=SERVING["tune_budget"], batch_size=1, seed=0,
                        n_init=4, objective=objective)
    wall_s = time.perf_counter() - t0
    if len(result.history) != SERVING["tune_budget"] \
            or not np.isfinite(result.best_value):
        fail("serving Study.tune: incomplete or non-finite history")
    print(f"serving Study.tune (budget {SERVING['tune_budget']}, {steps}-step "
          f"replays): default objective {result.default_value:.4f}, tuned "
          f"{result.best_value:.4f}, wall {wall_s:.3f} s", flush=True)
    return {"default": result.default_value, "tuned": result.best_value,
            "wall_s": wall_s}


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
    from repro_torch.kernels import page_migrate as pmk
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.kernels import select_topk as sk

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    seconds = build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(seconds)}", flush=True)

    topk_timing = phase_select_topk("cuda")
    phase_small_reference()
    phase_study_run()
    tune_launches = phase_tune()
    migrate_timing = phase_page_migrate()
    attention_timing = phase_paged_attention()
    serving_launches, _, _ = phase_serving()
    phase_serving_small()
    phase_kv_study()
    phase_serving_tune()

    def row(name, mod, timing, by_path):
        return {
            "name": name, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": timing["max_abs_err"], "matches_plain": True,
            "ms": timing["kernel_ms"], "kernel_ms": timing["kernel_ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": "bytes", "library_ms": timing["library_ms"]}

    kernels = [
        row("select_topk", sk, topk_timing,
            {"tune": tune_launches["select_topk"],
             "serving": serving_launches["select_topk"]}),
        row("page_migrate", pmk, migrate_timing,
            {"serving": serving_launches["page_migrate"]}),
        row("paged_attention", pak, attention_timing,
            {"serving": serving_launches["paged_attention"]}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
