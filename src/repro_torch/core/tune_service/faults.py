"""Fault-injection harness for the tune-service fleet (a copy of the
reference package's module, network injections included; the fleet's
workers apply the plan, and the flaky objectives below drive the local
executor's tests).

Robustness claims are only as good as the faults they were tested under,
so the fleet's test matrix is driven from here: a :class:`FaultPlan` is a
frozen, picklable schedule of worker misbehaviour keyed by **(unit
sequence number, attempt)** — the canonical work-unit coordinates that are
deterministic across runs, placements and resumes.  Because every worker
executes exactly ONE unit at a time, a fault keyed this way hits exactly
one lease no matter which worker drew the unit, which is what makes the
journal-twin byte-identity tests possible: two runs with the same plan
produce the same ``lease``/``expire``/``reissue`` histories even though
wall-clock scheduling differs.

Injectors (all applied worker-side, where the fleet actually breaks):

``kill``
    The worker process dies (``os._exit``) mid-segment — the coordinator
    sees the death (process sentinel / socket EOF), expires the lease
    immediately and re-issues the unit.
``stall``
    The worker stops heartbeating and swallows the unit's result — a
    wedged host.  The lease expires after ``lease_deadline`` missed
    heartbeats and the unit is re-issued; the stalled worker is written
    off.
``hang``
    The evaluation never returns but heartbeats keep flowing — a hung
    objective, not a dead worker.  Only the per-unit ``timeout_s`` can
    convert this into a FAILED result (satellite: the study must not
    wedge).
``drop``
    The result message is computed but never sent (message loss).  The
    lease expires and the unit is re-issued — duplicate execution is safe.
``dup``
    The result message is sent twice (message duplication).  The
    coordinator commits the first and asserts the twin bitwise equal.
``delay``
    The result message is sent ``seconds`` late (straggler).  The lease
    expires, the unit is re-issued, and whichever result lands first
    commits — the late twin is asserted equal against it.

Network-shaped injectors (socket transport only — they mangle frames at
the codec layer, so the authenticated transport's reject paths are
exercised by the same deterministic (unit, attempt) coordinates):

``corrupt``
    The result frame is sent with its last payload byte flipped — the
    signature no longer verifies, the coordinator journals a
    ``reject``/``bad-signature`` and drops the connection; the worker
    re-dials and the unit is re-issued.
``truncate``
    Half the result frame is sent, then the connection is closed (a
    crashed sender / cut link mid-frame).  Closing is what makes the
    fault deterministic: the coordinator always sees EOF-mid-frame
    (``truncated``), never a signature race against later heartbeats.
``replay``
    The result frame's raw bytes are sent twice.  The second copy has a
    stale sequence number, so it is rejected as a ``replay`` even though
    its signature verifies.
``partition``
    ``(unit, attempt, seconds)``: the link drops mid-lease — just before
    the unit's result frame, so the fault fires deterministically (every
    unit sends exactly one result) — and stays down for ``seconds``: the
    reconnect-with-backoff path.  The computed result survives the gap
    worker-side; on re-dial + re-greet the coordinator re-attaches the
    live lease (journalling ``reconnect``) and the result is delivered —
    or, if the lease already expired, first-commit-wins absorbs the
    duplicate.
``net_delay_s``
    Uniform latency: every frame send sleeps this long first (the
    benchmark's socket+latency arm; also settable via the
    ``REPRO_FLEET_NET_DELAY_S`` env var for CI).

The flaky-objective callables at the bottom inject *evaluation* faults
(raise / self-SIGKILL) through the normal ``objective=`` path; they are
module-level classes so process pools can pickle them, and they use
marker files (``O_CREAT | O_EXCL`` — atomic across processes) so "fail
the first N calls" stays exact under concurrency.

``tear_journal`` truncates a journal mid-line — the torn-write fault the
resume path must absorb.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Tuple


def _pairs(spec) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(u), int(a)) for u, a in spec)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of injected fleet faults.

    Every field is a tuple of ``(unit, attempt)`` pairs (``delay`` adds a
    ``seconds`` third element).  ``unit`` is the canonical work-unit
    sequence number (creation order, the executor's commit order);
    ``attempt`` is the lease attempt (0 = first issue, 1 = first
    re-issue, ...).  An empty plan injects nothing.
    """

    kill: Tuple[Tuple[int, int], ...] = ()
    stall: Tuple[Tuple[int, int], ...] = ()
    hang: Tuple[Tuple[int, int], ...] = ()
    drop: Tuple[Tuple[int, int], ...] = ()
    dup: Tuple[Tuple[int, int], ...] = ()
    delay: Tuple[Tuple[int, int, float], ...] = ()
    corrupt: Tuple[Tuple[int, int], ...] = ()
    truncate: Tuple[Tuple[int, int], ...] = ()
    replay: Tuple[Tuple[int, int], ...] = ()
    partition: Tuple[Tuple[int, int, float], ...] = ()
    #: uniform injected latency before every frame send (socket transport)
    net_delay_s: float = 0.0
    #: kill every worker whose unit satisfies ``unit % kill_every == which``
    #: on attempt 0 (the benchmark's "1-in-8 injected worker kills")
    kill_every: int = 0
    kill_phase: int = 0

    def __post_init__(self):
        object.__setattr__(self, "kill", _pairs(self.kill))
        object.__setattr__(self, "stall", _pairs(self.stall))
        object.__setattr__(self, "hang", _pairs(self.hang))
        object.__setattr__(self, "drop", _pairs(self.drop))
        object.__setattr__(self, "dup", _pairs(self.dup))
        object.__setattr__(self, "delay", tuple(
            (int(u), int(a), float(s)) for u, a, s in self.delay))
        object.__setattr__(self, "corrupt", _pairs(self.corrupt))
        object.__setattr__(self, "truncate", _pairs(self.truncate))
        object.__setattr__(self, "replay", _pairs(self.replay))
        object.__setattr__(self, "partition", tuple(
            (int(u), int(a), float(s)) for u, a, s in self.partition))

    def kills(self, unit: int, attempt: int) -> bool:
        if (unit, attempt) in self.kill:
            return True
        return bool(self.kill_every) and attempt == 0 and \
            unit % self.kill_every == self.kill_phase

    def stalls(self, unit: int, attempt: int) -> bool:
        return (unit, attempt) in self.stall

    def hangs(self, unit: int, attempt: int) -> bool:
        return (unit, attempt) in self.hang

    def drops(self, unit: int, attempt: int) -> bool:
        return (unit, attempt) in self.drop

    def dups(self, unit: int, attempt: int) -> bool:
        return (unit, attempt) in self.dup

    def delays(self, unit: int, attempt: int) -> float:
        for u, a, s in self.delay:
            if (u, a) == (unit, attempt):
                return s
        return 0.0

    def corrupts(self, unit: int, attempt: int) -> bool:
        return (unit, attempt) in self.corrupt

    def truncates(self, unit: int, attempt: int) -> bool:
        return (unit, attempt) in self.truncate

    def replays(self, unit: int, attempt: int) -> bool:
        return (unit, attempt) in self.replay

    def partitions(self, unit: int, attempt: int) -> float:
        for u, a, s in self.partition:
            if (u, a) == (unit, attempt):
                return s
        return 0.0

    @property
    def empty(self) -> bool:
        return not (self.kill or self.stall or self.hang or self.drop
                    or self.dup or self.delay or self.corrupt
                    or self.truncate or self.replay or self.partition
                    or self.net_delay_s or self.kill_every)


NO_FAULTS = FaultPlan()


def tear_journal(path: str, keep_lines: int, tail_bytes: int = 10) -> None:
    """Truncate ``path`` to ``keep_lines`` complete events plus
    ``tail_bytes`` of the next line — the torn final write a SIGKILL
    mid-append leaves behind."""
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    if keep_lines >= len(lines) - 1:
        raise ValueError(f"journal has only {len(lines) - 1} events")
    torn = b"\n".join(lines[:keep_lines]) + b"\n" + \
        lines[keep_lines][:tail_bytes]
    with open(path, "wb") as fh:
        fh.write(torn)


def _claim(marker_dir: str, prefix: str, n: int) -> bool:
    """Atomically claim one of ``n`` cross-process marker slots; returns
    True while claims remain (O_CREAT|O_EXCL — exactly n callers win)."""
    for i in range(n):
        try:
            fd = os.open(os.path.join(marker_dir, f"{prefix}{i}"),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            continue
        os.close(fd)
        return True
    return False


@dataclasses.dataclass
class FailNTimes:
    """Objective whose first ``n`` calls raise (a transient evaluation
    fault); later calls return ``config[knob]``.  Picklable; exact under
    process pools via atomic marker files in ``marker_dir``."""

    marker_dir: str
    n: int = 1
    knob: str = "sampling_period"

    def __call__(self, config) -> float:
        if _claim(self.marker_dir, "fail", self.n):
            raise RuntimeError("injected transient fault (FailNTimes)")
        return float(config[self.knob])


@dataclasses.dataclass
class KillNTimes:
    """Objective that SIGKILLs its own process on the first ``n`` calls —
    the process-pool worker-death fault.  Later calls return
    ``config[knob]``."""

    marker_dir: str
    n: int = 1
    knob: str = "sampling_period"
    grace_s: float = 0.05

    def __call__(self, config) -> float:
        if _claim(self.marker_dir, "kill", self.n):
            time.sleep(self.grace_s)  # die mid-unit, not at the boundary
            os.kill(os.getpid(), signal.SIGKILL)
        return float(config[self.knob])


@dataclasses.dataclass
class SlowObjective:
    """Objective that sleeps ``hang_s`` on selected trial values (a hung
    evaluation) — pair with ``timeout_s`` to test the un-wedge path."""

    marker_dir: str
    n: int = 1
    hang_s: float = 3600.0
    knob: str = "sampling_period"

    def __call__(self, config) -> float:
        if _claim(self.marker_dir, "hang", self.n):
            time.sleep(self.hang_s)
        return float(config[self.knob])
