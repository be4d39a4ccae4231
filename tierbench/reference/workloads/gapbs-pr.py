"""GAP Benchmark Suite PageRank (Beamer et al., arXiv:1508.03619) on a
Kronecker graph, as the paper's Table 4 sizes it (71.29 GiB): the trace
the simulator's GAPBS generator makes, from its build seed.

Eight iterations of ten epochs.  A hot core of 3% of the pages (the rank
arrays, allocated first) takes 30% of the accesses; 65% stream through a
window of the cold edge pages that moves each epoch with no reuse; the
rest is spread evenly.  85% reads.  The trace does not depend on the
seed (the generator's random draws serve other kernels and inputs).
"""

from __future__ import annotations

import numpy as np

PAGE_BYTES = 2 * 1024 * 1024
BASE_RATE_PER_THREAD = 40e6


def build(input_name: str, threads: int, scale: float, seed: int):
    if input_name != "kron":
        raise ValueError(f"the reference holds PageRank on kron only, got "
                         f"{input_name!r}")
    rss = 71.29
    n = max(64, int(rss * (2 ** 30) / PAGE_BYTES * scale))
    n_iters, epochs_per_iter = 8, 10
    n_epochs, epoch_ms = n_iters * epochs_per_iter, 500.0
    A = threads * BASE_RATE_PER_THREAD * (epoch_ms / 1e3) * scale
    n_core = max(8, int(n * 0.03))
    core = np.arange(n_core)

    def epoch_access(e: int):
        w = np.full(n, 1e-12)
        w[core] += 0.30 / n_core
        w += 0.05 / n
        pos = e % epochs_per_iter
        cold_lo, cold_n = n_core, n - n_core
        win = max(1, cold_n // epochs_per_iter)
        lo = cold_lo + pos * win
        hi = min(lo + win, n)
        w[lo:hi] += 0.65 / max(hi - lo, 1)
        s = w.sum()
        w = w / s if s > 0 else w
        acc = A * w
        return 0.85 * acc, 0.15 * acc

    return {"n_pages": n, "n_epochs": n_epochs, "epoch_ms": epoch_ms,
            "threads": threads, "mlp": 7.0, "compute_ms": 180.0,
            "scale": scale, "epoch_access": epoch_access}
