"""Asynchronous trial-executor tuning service of the PyTorch port
(deterministic, resumable, fault-tolerant).

The package behind ``Study.tune(executor="async"|"fleet", slots=N,
scheduler="asha"|None, journal=..., resume=...)``:

* :mod:`.trial` -- the PENDING/RUNNING/PAUSED/TERMINATED/FAILED trial state
  machine, carrying the frozen spec, RNG counters and the mid-run epoch
  loop checkpoint (the host carry);
* :mod:`.executor` -- N saturated evaluation slots (threads, or processes
  started by spawn) with results committed in canonical unit-creation
  order;
* :mod:`.coordinator` + :mod:`.worker` -- the multi-host rung: a
  lease-and-commit coordinator serving ONE shared work queue to worker
  processes (always spawned; each warms the card up before it greets),
  with heartbeats, straggler re-issue (duplicate execution is safe --
  first commit wins, the twin is asserted bitwise equal), bounded
  respawns, worker reconnect-with-backoff and graceful degradation to a
  local slot;
* :mod:`.transport` -- the authenticated socket frame codec (HMAC-signed,
  length-capped, replay-protected, bounded reads; the reference's frames
  byte for byte) plus the frozen-JSON
  :class:`~repro_torch.core.tune_service.transport.FleetSpec` that
  ``python -m repro_torch.launch.fleet`` deploys fleets from;
* :mod:`.faults` -- the fault-injection harness (worker and network
  injections keyed by deterministic unit coordinates, and flaky
  objectives);
* :mod:`.asha` -- asynchronous successive halving over 1/4, 1/2 and full
  epoch rungs;
* :mod:`.journal` -- the JSON-lines study journal; a killed study resumes
  by replaying the deterministic control loop against the journal as an
  evaluation cache, byte-identically;
* :mod:`.service` -- the control loop tying the above together.
"""

from .asha import ASHAScheduler, PROMOTE, RUNG_FRACTIONS, STOP
from .coordinator import FleetExecutor
from .executor import MAX_POOL_REBUILDS, TrialExecutor
from .faults import (FailNTimes, FaultPlan, KillNTimes, NO_FAULTS,
                     SlowObjective, tear_journal)
from .journal import StudyJournal, VERSION, read_events
from .service import AsyncTuningResult, TuneService
from .transport import (FleetSpec, FrameChannel, FrameError,
                        FrameReplayError, FrameSignatureError,
                        FrameTimeoutError, FrameTooLargeError,
                        FrameTruncatedError)
from .trial import (FAILED, PAUSED, PENDING, RUNNING, TERMINATED,
                    TRANSITIONS, Trial)

__all__ = [
    "ASHAScheduler", "PROMOTE", "RUNG_FRACTIONS", "STOP",
    "FleetExecutor", "MAX_POOL_REBUILDS", "TrialExecutor",
    "FailNTimes", "FaultPlan", "KillNTimes", "NO_FAULTS",
    "SlowObjective", "tear_journal",
    "StudyJournal", "VERSION", "read_events",
    "AsyncTuningResult", "TuneService",
    "FleetSpec", "FrameChannel", "FrameError", "FrameReplayError",
    "FrameSignatureError", "FrameTimeoutError", "FrameTooLargeError",
    "FrameTruncatedError",
    "FAILED", "PAUSED", "PENDING", "RUNNING", "TERMINATED",
    "TRANSITIONS", "Trial",
]
