"""ASHA successive halving on partial-epoch objectives (a copy of the
reference package's module).

Asynchronous Successive Halving (Li et al.): evaluate every trial to a
small epoch budget first, promote only the promising fraction to the next
rung, and terminate the rest — most tuning compute goes to candidates that
are already visibly doomed at a quarter of the budget, and the epoch
loop's checkpointable host carry makes the partial evaluations cheap to
extend instead of recompute.

Rung budgets default to ¼ / ½ / full epochs.  Promotion is the
asynchronous rule: when a trial lands at rung ``r`` with value ``v``, it is
promoted iff ``v`` ranks within the top ``1/eta`` of ALL rung-``r`` results
committed so far (itself included; ties break by trial index, earlier
wins); with fewer than ``eta`` results only the current best promotes.
Decisions are made at canonical journal-commit time, never at wall-clock
arrival, so the promotion sequence — like everything else in the service —
is a deterministic function of the study parameters.

Early-terminated trials still inform the optimizer: their partial value is
extrapolated to full budget (``value * E / epochs_run``) before ``tell``,
so a trial stopped at ¼ budget does not masquerade as a 4x-faster config in
the surrogate.
"""

from __future__ import annotations

import math
from typing import List, Tuple

#: default rung budgets as fractions of the full epoch budget
RUNG_FRACTIONS = (0.25, 0.5, 1.0)

PROMOTE = "promote"
STOP = "stop"


class ASHAScheduler:
    """Successive-halving rung bookkeeping for one study."""

    name = "asha"

    def __init__(self, max_epochs: int, eta: int = 4,
                 rung_fractions=RUNG_FRACTIONS):
        if max_epochs < 1:
            raise ValueError("max_epochs must be >= 1")
        if eta < 2:
            raise ValueError(f"eta must be >= 2, got {eta}")
        self.max_epochs = int(max_epochs)
        self.eta = int(eta)
        epochs: List[int] = []
        for f in rung_fractions:
            e = min(self.max_epochs, max(1, int(math.ceil(max_epochs * f))))
            if not epochs or e > epochs[-1]:  # dedupe degenerate tiny budgets
                epochs.append(e)
        if epochs[-1] != self.max_epochs:
            epochs.append(self.max_epochs)
        #: epoch budget per rung; the last rung is always the full budget
        self.rung_epochs: Tuple[int, ...] = tuple(epochs)
        #: committed (value, trial_index) pairs per rung, commit order
        self.results: List[List[Tuple[float, int]]] = \
            [[] for _ in self.rung_epochs]

    @property
    def n_rungs(self) -> int:
        return len(self.rung_epochs)

    def is_final(self, rung: int) -> bool:
        return rung >= self.n_rungs - 1

    def report(self, rung: int, trial_index: int, value: float) -> str:
        """Record a committed rung result and decide the trial's fate.

        Must be called in canonical commit order; the decision depends only
        on the results committed before this one (plus this one), which is
        what makes kill/resume replay exact.
        """
        if self.is_final(rung):
            raise ValueError(f"rung {rung} is the final budget; no decision")
        pool = self.results[rung]
        pool.append((float(value), int(trial_index)))
        k = max(1, len(pool) // self.eta)  # promotion slots so far
        me = (float(value), int(trial_index))
        rank = sum(1 for r in pool if r < me)  # ties -> earlier trial wins
        return PROMOTE if rank < k else STOP
