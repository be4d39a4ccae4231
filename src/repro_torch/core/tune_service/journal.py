"""JSON-lines study journal: every decision appended, replayable exactly
(a copy of the reference package's module; same schema and bytes).

The journal is the study's source of truth for resume.  Because the whole
control loop is deterministic (asks, rung decisions and tells all happen at
canonical *commit* events, never at wall-clock arrival — see
:mod:`.service`), the event sequence a study emits is a pure function of
``(spec, tune parameters)``.  Resume therefore does not reconstruct state
from the journal; it RE-RUNS the control loop and uses the journal as an
evaluation cache: events that match the recorded prefix are consumed
(asserted equal for asks — a mismatch means the study parameters changed),
recorded evaluation values substitute for simulation, and the first event
past the recorded prefix switches the journal back into append mode.  A
killed-then-resumed study thus produces a byte-identical journal to its
uninterrupted twin (pinned in tests).

Events are deliberately wall-clock-free; timing receipts live only in the
in-memory :class:`~repro_torch.core.tune_service.service.AsyncTuningResult`.

Event types (all objects carry ``"event"``):

``study``
    Header: schema ``version``, frozen ``spec`` dict, ``budget``,
    ``slots``, ``scheduler`` (+ rung epoch budgets), optimizer parameters.
``default``
    The default-config baseline evaluation (not told to the optimizer).
``ask``
    Trial creation: ``trial`` index, CRN ``group`` id, suggested
    ``config``.
``eval``
    A committed evaluation segment: ``trial``, cumulative ``epochs``,
    objective ``value`` over those epochs.
``rung``
    An ASHA decision: ``trial``, ``rung`` index, ``decision``
    (``"promote"``/``"stop"``).
``fail``
    A FAILED trial: ``trial``, attempted ``epochs``, ``error`` traceback.
``retry``
    A bounded trial retry (version 2): ``trial``, the retry ``attempt``
    number, attempted ``epochs``, the transient ``error`` being retried.
``lease`` / ``expire`` / ``reissue``
    Fleet lease lifecycle (version 2), journaled as the work unit's
    attempt history at its COMMIT point — never at wall-clock detection
    time — so fleet journals stay deterministic.  ``lease`` records the
    unit's first dispatch (``unit``, ``attempt`` 0, the configured
    ``deadline`` in heartbeat counts — wall-clock-free); ``expire``
    records a lost lease (``unit``, ``attempt``, ``reason``); ``reissue``
    records the straggler re-issue that followed (``unit``, the new
    ``attempt``).
``reject`` / ``reconnect``
    Socket-transport lease events (version 3), journaled through the
    same commit-time history mechanism.  ``reject`` records an invalid
    frame (bad signature, oversize, replayed, truncated — ``unit``,
    ``attempt``, the transport ``reason``) that killed a live lease; the
    matching ``expire`` (reason ``"reject"``) follows it.  ``reconnect``
    records a worker whose connection dropped mid-lease re-greeting and
    having the live lease re-attached (``unit``, ``attempt``).  Rejected
    frames not attributable to a live lease (unauthenticated strangers,
    replays landing after their twin committed) are wall-clock-dependent
    and therefore never journaled — they appear in fleet stats only.
``tell``
    An optimizer update: ``trial``, CRN ``group``, the (possibly
    extrapolated / CRN-debiased) ``value`` recorded.
``done``
    Study completion: ``best_trial``, ``best_value``, trial-state counts.

``tools/journal_schema.py`` validates these invariants standalone.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, List, Optional

#: journal schema version (bumped on incompatible event changes)
#: v2: adds ``retry`` and the fleet lease lifecycle events
#: (``lease``/``expire``/``reissue``)
#: v3: adds the socket-transport lease events ``reject``/``reconnect``
VERSION = 3


def _read_clean(path: str) -> "tuple[List[Dict[str, Any]], int]":
    """Parse a journal, tolerating a truncated final line (SIGKILL landed
    mid-append).  Returns the events plus the byte length of the clean
    prefix (torn tail excluded).  Raises on corruption anywhere else."""
    events: List[Dict[str, Any]] = []
    with io.open(path, "rb") as fh:
        raw = fh.read()
    lines = raw.split(b"\n")
    # a complete journal ends with "\n" -> last split element is b""
    tail_ok = lines and lines[-1] == b""
    body = lines[:-1] if lines else []
    clean = 0
    for i, line in enumerate(body):
        try:
            events.append(json.loads(line.decode("utf-8")))
            clean += len(line) + 1
        except ValueError:
            if i == len(body) - 1 and not tail_ok:
                break  # torn final write
            raise
    return events, clean


def read_events(path: str) -> List[Dict[str, Any]]:
    """Parse a journal, tolerating a truncated final line (SIGKILL landed
    mid-append).  Raises on corruption anywhere else."""
    return _read_clean(path)[0]


class StudyJournal:
    """Append-mode JSONL journal with deterministic-replay dedup.

    Construct with ``resume=True`` to preload the existing event prefix:
    :meth:`append` then *consumes* matching prefix events instead of
    re-writing them (returning the recorded event, which may carry the
    cached evaluation value), and only events past the prefix hit the
    file.  ``strict`` prefix checking applies to replay-deterministic
    fields; a mismatch raises — the resumed parameters differ from the
    journaled study.
    """

    def __init__(self, path: str, resume: bool = False):
        self.path = path
        self._replay: List[Dict[str, Any]] = []
        self._pos = 0
        self._fh: Optional[io.TextIOBase] = None
        if resume:
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"resume=True but journal {path!r} does not exist")
            self._replay, clean = _read_clean(path)
            if clean < os.path.getsize(path):
                # drop the torn final write so appends continue from the
                # last complete event (keeps resumed journals byte-
                # identical to an uninterrupted run's)
                os.truncate(path, clean)

    # -- replay cache ------------------------------------------------------
    @property
    def replaying(self) -> bool:
        return self._pos < len(self._replay)

    def lookup(self, event: str, **match) -> Optional[Dict[str, Any]]:
        """Find a not-yet-consumed replay event by type + field equality
        (used to pre-check cache hits without consuming)."""
        for ev in self._replay[self._pos:]:
            if ev.get("event") != event:
                continue
            if all(ev.get(k) == v for k, v in match.items()):
                return ev
        return None

    def lookup_first(self, events: "tuple", **match
                     ) -> Optional[Dict[str, Any]]:
        """Find the FIRST not-yet-consumed replay event whose type is any
        of ``events`` and whose fields match.  Order matters when a trial
        segment was retried: its ``retry`` event precedes the eventual
        ``eval``/``fail`` at the same epochs, and replay must rediscover
        them in that order."""
        for ev in self._replay[self._pos:]:
            if ev.get("event") not in events:
                continue
            if all(ev.get(k) == v for k, v in match.items()):
                return ev
        return None

    def consume_history(self, events: "tuple",
                        unit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Consume the contiguous run of recorded events at the cursor
        whose type is in ``events`` (optionally pinned to one ``unit``)
        and return them.

        This is the replay path for fleet lease histories attached to a
        CACHED unit (a replay cache hit never re-executes, so nothing
        re-generates its ``lease``/``expire``/``reissue`` events — the
        recorded ones are adopted verbatim).  Live units re-generate their
        histories deterministically and go through the strict
        :meth:`append` check instead."""
        out: List[Dict[str, Any]] = []
        while self._pos < len(self._replay):
            ev = self._replay[self._pos]
            if ev.get("event") not in events:
                break
            if unit is not None and ev.get("unit") != unit:
                break
            out.append(ev)
            self._pos += 1
        return out

    # -- append ------------------------------------------------------------
    def append(self, event: Dict[str, Any],
               check: bool = True) -> Dict[str, Any]:
        """Record one event.  During replay, consume and return the
        recorded twin instead of writing; past the prefix, write through.

        ``check`` asserts the deterministic fields of the emitted event
        match the recorded one (event type always; other keys when present
        in both) — the guard that a resumed study is replaying the SAME
        study.
        """
        if self._pos < len(self._replay):
            recorded = self._replay[self._pos]
            if check:
                if recorded.get("event") != event.get("event"):
                    raise ValueError(
                        f"journal replay diverged at event {self._pos}: "
                        f"recorded {recorded.get('event')!r}, study emitted "
                        f"{event.get('event')!r} — the resumed parameters "
                        f"do not match the journaled study")
                for k, v in event.items():
                    if k in recorded and recorded[k] != v and v is not None:
                        raise ValueError(
                            f"journal replay diverged at event {self._pos} "
                            f"({event.get('event')!r}): field {k!r} recorded "
                            f"as {recorded[k]!r}, study emitted {v!r}")
            self._pos += 1
            return recorded
        self._write(event)
        return event

    def _write(self, event: Dict[str, Any]) -> None:
        if self._fh is None:
            self._fh = io.open(self.path, "a", encoding="utf-8")
        self._fh.write(json.dumps(event, sort_keys=True) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "StudyJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
