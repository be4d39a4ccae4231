"""Page and tier-placement state, in numpy: a copy of the reference
package's ``repro.core.pages``.

A *page* is the migration granule (2 MiB huge page, as in HeMem).  Placement
is a single boolean vector ``in_fast``: every allocated page is owned by
exactly one tier at any instant, and migration is copy-then-flip.
:class:`BatchTierState` keeps ``(B, n_pages)`` placement arrays;
:class:`TierState` is its ``B = 1`` view.  The numpy HeMem engine
(:mod:`repro_torch.core.engine`) and
:class:`~repro_torch.core.tiered_params.TieredParamStore` use them; the
compiled epoch loop keeps placement in its own carry
(:mod:`repro_torch.core.engine_torch`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

PAGE_BYTES = 2 * 1024 * 1024  # 2 MiB huge pages, HeMem's migration granule


def migration_rate_pages(rate_gibs, epoch_ms, page_bytes: int,
                         scale: float = 1.0):
    """Pages movable this epoch under a GiB/s migration-rate cap.

    One shared definition for the cap every engine and the simulator used to
    compute inline: ``rate * 2**30 * epoch_s / page_bytes`` (optionally scaled
    by the simulation ``scale`` so sim-page counts stay consistent with the
    scaled bandwidth).  Accepts scalars or ``(B,)`` arrays and preserves the
    historical ``int()`` truncation semantics.
    """
    raw = rate_gibs * (2 ** 30) * (epoch_ms / 1e3) / page_bytes * scale
    if np.ndim(raw) == 0:
        return max(0, int(raw))
    return np.maximum(0, np.asarray(raw).astype(np.int64))


@dataclasses.dataclass
class MigrationPlan:
    """Result of one simulator epoch of migration-thread activity."""

    promote: np.ndarray  # page indices slow -> fast
    demote: np.ndarray   # page indices fast -> slow

    @staticmethod
    def empty() -> "MigrationPlan":
        z = np.zeros(0, dtype=np.int64)
        return MigrationPlan(promote=z, demote=z)

    @property
    def n_pages(self) -> int:
        return int(len(self.promote) + len(self.demote))


class BatchTierState:
    """Two-tier placement of ``n_pages`` pages for a batch of B configs.

    Every config in the batch sees the same workload but migrates
    independently, so placement is a ``(B, n_pages)`` boolean matrix.
    First-touch allocation mirrors HeMem: allocations land in the fast tier
    (DRAM) while it has free space, then overflow to the slow tier (NVM/CXL).
    """

    def __init__(self, batch: int, n_pages: int, fast_capacity_pages: int,
                 page_bytes: int = PAGE_BYTES):
        if batch < 1:
            raise ValueError("batch must be >= 1")
        if fast_capacity_pages < 0:
            raise ValueError("fast_capacity_pages must be >= 0")
        self.batch = int(batch)
        self.n_pages = int(n_pages)
        self.page_bytes = int(page_bytes)
        self.fast_capacity = int(fast_capacity_pages)
        self.in_fast = np.zeros((self.batch, self.n_pages), dtype=bool)
        self.allocated = np.zeros((self.batch, self.n_pages), dtype=bool)
        # True while every allocation call used a shared (n,) mask — rows are
        # then provably identical and allocation can take row-0 shortcuts
        self._alloc_rows_uniform = True
        # lifetime counters (used by benchmarks / figures)
        self.total_promoted = np.zeros(self.batch, dtype=np.int64)
        self.total_demoted = np.zeros(self.batch, dtype=np.int64)

    # -- invariant helpers ---------------------------------------------------
    @property
    def fast_used(self) -> np.ndarray:
        return self.in_fast.sum(axis=1)

    @property
    def fast_free(self) -> np.ndarray:
        return self.fast_capacity - self.fast_used

    def check_invariants(self) -> None:
        assert (self.fast_used <= self.fast_capacity).all(), \
            "fast tier over capacity"
        assert not (self.in_fast & ~self.allocated).any(), \
            "unallocated page in fast"

    # -- allocation ------------------------------------------------------------
    def allocate_first_touch(self, touched: np.ndarray) -> np.ndarray:
        """Allocate newly-touched pages (fast first, then slow).

        ``touched`` is either a shared ``(n_pages,)`` mask (the common case:
        all configs see the same trace) or a per-config ``(B, n_pages)``
        matrix.  Returns the per-config count of newly allocated pages.
        """
        touched = np.asarray(touched, dtype=bool)
        if touched.ndim == 1:
            # allocation is placement-independent, so as long as every call
            # used a shared mask all rows allocate identically — a cheap
            # row-0 check then skips the (B, n) work on the (common)
            # no-new-pages epochs
            if self._alloc_rows_uniform and \
                    not (touched & ~self.allocated[0]).any():
                return np.zeros(self.batch, dtype=np.int64)
            touched = np.broadcast_to(touched, self.in_fast.shape)
        else:
            self._alloc_rows_uniform = False
        new = touched & ~self.allocated
        counts = new.sum(axis=1)
        if not counts.any():
            return counts
        self.allocated |= new
        room = self.fast_free
        # first-touch order == page-index order: the first `room` new pages
        # of each row go fast (same selection as the historical new[:room])
        rank = np.cumsum(new, axis=1)
        self.in_fast |= new & (rank <= room[:, None])
        return counts

    # -- migration ---------------------------------------------------------------
    def apply(self, plans: Sequence[MigrationPlan]) -> None:
        """Apply per-config plans: demotions then promotions (HeMem frees room
        before filling it)."""
        assert len(plans) == self.batch, "one MigrationPlan per config"
        for b, plan in enumerate(plans):
            if len(plan.demote):
                d = plan.demote
                assert self.in_fast[b, d].all(), \
                    "demoting a page not in fast tier"
                self.in_fast[b, d] = False
                self.total_demoted[b] += len(d)
            if len(plan.promote):
                p = plan.promote
                assert self.allocated[b, p].all(), \
                    "promoting an unallocated page"
                assert not self.in_fast[b, p].any(), \
                    "promoting a page already in fast tier"
                self.in_fast[b, p] = True
                self.total_promoted[b] += len(p)
        self.check_invariants()


class TierState:
    """Single-config two-tier placement: a thin ``B=1`` view of
    :class:`BatchTierState` kept for existing callers."""

    def __init__(self, n_pages: int, fast_capacity_pages: int,
                 page_bytes: int = PAGE_BYTES):
        self.batch_state = BatchTierState(1, n_pages, fast_capacity_pages,
                                          page_bytes)
        self.n_pages = self.batch_state.n_pages
        self.page_bytes = self.batch_state.page_bytes
        self.fast_capacity = self.batch_state.fast_capacity

    # -- batched-state views --------------------------------------------------
    @property
    def in_fast(self) -> np.ndarray:
        return self.batch_state.in_fast[0]

    @property
    def allocated(self) -> np.ndarray:
        return self.batch_state.allocated[0]

    @property
    def total_promoted(self) -> int:
        return int(self.batch_state.total_promoted[0])

    @property
    def total_demoted(self) -> int:
        return int(self.batch_state.total_demoted[0])

    # -- invariant helpers ---------------------------------------------------
    @property
    def fast_used(self) -> int:
        return int(self.in_fast.sum())

    @property
    def fast_free(self) -> int:
        return self.fast_capacity - self.fast_used

    def check_invariants(self) -> None:
        self.batch_state.check_invariants()

    # -- allocation ------------------------------------------------------------
    def allocate_first_touch(self, touched: np.ndarray) -> int:
        """Allocate newly-touched pages (fast first, then slow). Returns #new."""
        return int(self.batch_state.allocate_first_touch(touched)[0])

    # -- migration ---------------------------------------------------------------
    def apply(self, plan: MigrationPlan) -> None:
        """Apply demotions then promotions (HeMem frees room before filling it)."""
        self.batch_state.apply([plan])
