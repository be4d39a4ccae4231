"""Trial: the resumable state machine one tuning candidate moves through
(a copy of the reference package's module).

A trial is one suggested knob configuration plus everything needed to
(re-)evaluate it deterministically: the frozen
:class:`~repro_torch.core.specs.ExperimentSpec` dict it runs under, the
encoded config row, and its RNG counters (simulation seed + global batch
offset -- with the epoch loop's counter-based draws these make the trial's
evaluation placement-invariant: any executor, any slot, any segmentation
produces bitwise-identical numbers).

States (Ray Tune's ``trial.py`` shape, collapsed to what a deterministic
single-study executor needs)::

    PENDING --> RUNNING --> TERMINATED      (budget reached, or ASHA-stopped)
                   |   \\--> FAILED          (objective raised; traceback kept)
                   v
                PAUSED  --> RUNNING          (checkpointed at a rung boundary,
                                              promoted and resumed)

``TERMINATED`` covers both full-budget completion and early ASHA
termination -- ``epochs_run < max_epochs`` distinguishes them.  A PAUSED
trial carries its mid-run epoch-loop checkpoint (the host carry,
:func:`repro_torch.core.engine_torch.carry_to_host`) so promotion resumes
from the rung boundary instead of epoch 0; a custom objective has no
carry and a trial whose earlier rungs were journal-replay cache hits has
none either, and both re-run from epoch 0 (exact either way -- see
:func:`repro_torch.core.simulator.run_simulation_segment`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
FAILED = "FAILED"

#: legal state transitions (from -> allowed targets)
TRANSITIONS = {
    PENDING: (RUNNING,),
    RUNNING: (PAUSED, TERMINATED, FAILED),
    PAUSED: (RUNNING,),
    TERMINATED: (),
    FAILED: (),
}


@dataclasses.dataclass
class Trial:
    """One tuning candidate's full lifecycle state."""

    index: int                          # canonical creation-sequence id
    config: Dict[str, Any]              # validated knob config
    encoded: np.ndarray                 # KnobSpace.encode(config) unit row
    spec: Dict[str, Any]                # frozen ExperimentSpec (replayable)
    seed: int                           # simulation seed (RNG counter base)
    batch_offset: int = 0               # global batch index (RNG counter)
    group: int = 0                      # CRN ask-group id (asked together)
    state: str = PENDING
    rung: int = 0                       # current ASHA rung index
    epochs_run: int = 0                 # committed evaluated epochs
    value: Optional[float] = None       # objective over epochs_run epochs
    told_value: Optional[float] = None  # value fed to the optimizer
    error: Optional[str] = None         # traceback text (FAILED)
    attempt: int = 0                    # bounded-retry count (transients)
    checkpoint: Any = None              # host carry at epochs_run
    wall_s: float = 0.0                 # evaluation wall clock spent
    #: per-epoch wall_ms history (float64), appended per committed segment;
    #: rung values re-sum this array so live (carry-resumed) and replayed
    #: (from-scratch) evaluations commit bitwise-identical values
    epoch_wall_ms: List[np.ndarray] = dataclasses.field(default_factory=list)

    def advance(self, new_state: str) -> None:
        if new_state not in TRANSITIONS:
            raise ValueError(f"unknown trial state {new_state!r}")
        if new_state not in TRANSITIONS[self.state]:
            raise ValueError(
                f"illegal trial transition {self.state} -> {new_state} "
                f"(trial {self.index})")
        self.state = new_state

    @property
    def terminal(self) -> bool:
        return self.state in (TERMINATED, FAILED)

    def wall_concat(self) -> np.ndarray:
        """Per-epoch wall_ms over everything evaluated so far, one array."""
        if not self.epoch_wall_ms:
            return np.zeros(0, dtype=np.float64)
        if len(self.epoch_wall_ms) == 1:
            return self.epoch_wall_ms[0]
        return np.concatenate(self.epoch_wall_ms)

    def value_at(self, epochs: int) -> float:
        """Objective (total seconds) over the first ``epochs`` epochs,
        computed canonically from the per-epoch wall history — independent
        of how many segments produced it."""
        wall = self.wall_concat()
        if len(wall) < epochs:
            raise ValueError(
                f"trial {self.index} has {len(wall)} evaluated epochs, "
                f"needs {epochs}")
        return float(wall[:epochs].sum() / 1e3)

    def to_row(self) -> Dict[str, Any]:
        """The trial-table row (journal/result payload; checkpoint and
        per-epoch arrays omitted — both are re-derivable)."""
        return {
            "index": self.index,
            "config": dict(self.config),
            "seed": int(self.seed),
            "batch_offset": int(self.batch_offset),
            "group": int(self.group),
            "state": self.state,
            "rung": int(self.rung),
            "epochs_run": int(self.epochs_run),
            "value": self.value,
            "told_value": self.told_value,
            "error": self.error,
            "attempt": int(self.attempt),
        }
