"""Asynchronous trial-executor tuning service of the PyTorch port
(deterministic, resumable, fault-tolerant).

The package behind ``Study.tune(executor="async", slots=N,
scheduler="asha"|None, journal=..., resume=...)``:

* :mod:`.trial` -- the PENDING/RUNNING/PAUSED/TERMINATED/FAILED trial state
  machine, carrying the frozen spec, RNG counters and the mid-run epoch
  loop checkpoint (the host carry);
* :mod:`.executor` -- N saturated evaluation slots (threads, or processes
  started by spawn) with results committed in canonical unit-creation
  order;
* :mod:`.faults` -- the fault-injection harness (worker and network
  injections keyed by deterministic unit coordinates, and flaky
  objectives);
* :mod:`.asha` -- asynchronous successive halving over 1/4, 1/2 and full
  epoch rungs;
* :mod:`.journal` -- the JSON-lines study journal; a killed study resumes
  by replaying the deterministic control loop against the journal as an
  evaluation cache, byte-identically;
* :mod:`.service` -- the control loop tying the above together.

The fleet executor (the reference's coordinator, worker and socket
transport) is not ported yet (ROADMAP queue 1, item 8c).
"""

from .asha import ASHAScheduler, PROMOTE, RUNG_FRACTIONS, STOP
from .executor import MAX_POOL_REBUILDS, TrialExecutor
from .faults import (FailNTimes, FaultPlan, KillNTimes, NO_FAULTS,
                     SlowObjective, tear_journal)
from .journal import StudyJournal, VERSION, read_events
from .service import AsyncTuningResult, TuneService
from .trial import (FAILED, PAUSED, PENDING, RUNNING, TERMINATED,
                    TRANSITIONS, Trial)

__all__ = [
    "ASHAScheduler", "PROMOTE", "RUNG_FRACTIONS", "STOP",
    "MAX_POOL_REBUILDS", "TrialExecutor",
    "FailNTimes", "FaultPlan", "KillNTimes", "NO_FAULTS",
    "SlowObjective", "tear_journal",
    "StudyJournal", "VERSION", "read_events",
    "AsyncTuningResult", "TuneService",
    "FAILED", "PAUSED", "PENDING", "RUNNING", "TERMINATED",
    "TRANSITIONS", "Trial",
]
