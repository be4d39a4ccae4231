"""GUPS with an 8 GiB hot set in 64 GiB (HeMem's benchmark, the paper's
Table 4): the trace the simulator's GUPS generator makes, from its build
seed.

Read-modify-write updates (reads equal writes).  90% of the accesses go to
a hot set of an eighth of the pages, scattered uniformly over the address
space; at half time the hot set moves to another random eighth.
"""

from __future__ import annotations

import numpy as np

PAGE_BYTES = 2 * 1024 * 1024
#: accesses per second one thread issues at fast-tier speed
BASE_RATE_PER_THREAD = 40e6


def build(input_name: str, threads: int, scale: float, seed: int):
    rss = 64.03
    n = max(64, int(rss * (2 ** 30) / PAGE_BYTES * scale))
    n_epochs, epoch_ms = 60, 500.0
    rng = np.random.default_rng(seed + 17)
    n_hot = max(8, int(n * (8.0 / 64.0)))
    hot1 = rng.choice(n, size=n_hot, replace=False)
    hot2 = rng.choice(n, size=n_hot, replace=False)
    A = threads * BASE_RATE_PER_THREAD * (epoch_ms / 1e3) * scale
    base = np.full(n, 0.10 / n)
    w1 = base.copy()
    w1[hot1] += 0.90 / n_hot
    w2 = base.copy()
    w2[hot2] += 0.90 / n_hot

    def epoch_access(e: int):
        acc = A * (w1 if e < n_epochs // 2 else w2)
        return 0.5 * acc, 0.5 * acc

    return {"n_pages": n, "n_epochs": n_epochs, "epoch_ms": epoch_ms,
            "threads": threads, "mlp": 8.0, "compute_ms": 40.0,
            "scale": scale, "epoch_access": epoch_access}
