"""TuneService: the deterministic asynchronous tuning control loop (the
reference package's service, on the port's epoch loop).

``Study.tune(executor="async"|"fleet", ...)`` lands here.  The service
owns the optimizer (SMAC / random), the optional ASHA scheduler, the study
journal and a :class:`~repro_torch.core.tune_service.executor.TrialExecutor`
(or, under ``executor="fleet"``, a
:class:`~repro_torch.core.tune_service.coordinator.FleetExecutor`), and
drives them with ONE invariant: **every decision happens at canonical
commit time**.  Work units (trial evaluation segments) are created in a
deterministic order; the executor runs them on whichever slot frees first
but hands results back in creation order; asks, rung decisions and CRN
tells all fire at those commits.  Consequently the entire study -- trial
table, journal, incumbent -- is a pure function of ``(spec, budget, slots,
scheduler, optimizer parameters)``, independent of wall-clock completion
order, thread scheduling, or being killed and resumed.

The ask-ahead window generalizes the synchronous loop: a new trial is
asked whenever fewer than ``slots`` units are outstanding and budget
remains.  At ``slots=1`` with no scheduler this reduces *exactly* to the
sequential ask -> evaluate -> tell loop (same optimizer-RNG consumption,
same B=1 evaluations, same seeds/batch offsets), so the synchronous
path's incumbent is reproduced bit-identically.

CRN groups: trials asked together at one window refill form a group;
their tells are buffered and committed per-group (``tell_batch(crn=)``)
once every member lands, in trial-index order.  Singleton groups use plain
``tell`` (matching the sequential loop).

Each segment runs :func:`~repro_torch.core.simulator.run_simulation_segment`
on the spec's device; on local slots a trial promoted by ASHA resumes from
its rung's host carry, so the card simulates every epoch of a study once.
Under the fleet no carry crosses the transport: a rung unit re-derives
``[0, hi)`` from scratch (segmented equals unsegmented bitwise), so the
study's decisions are the local slots' and the card simulates the
promoted trials' prefixes again.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np

from .. import engine_torch
from ..bo.smac import Observation, RandomSearch, SMACOptimizer
from ..bo.tuner import TuningResult
from ..knobs import KnobSpace, get_space
from ..simulator import run_simulation_segment
from ..workloads import make_workload
from .asha import ASHAScheduler, PROMOTE
from .executor import TrialExecutor
from .faults import NO_FAULTS, FaultPlan
from .journal import VERSION, StudyJournal
from .trial import FAILED, PAUSED, RUNNING, TERMINATED, Trial

SCHEDULERS = (None, "asha")
EXECUTORS = ("local", "fleet")

#: fleet lease lifecycle event types (journaled at unit commit time);
#: ``reject`` (an invalid frame killed the lease) and ``reconnect`` (a
#: re-greeted worker re-attached its live lease) ride along
HISTORY_EVENTS = ("lease", "expire", "reissue", "reject", "reconnect")


def _jsonify(obj):
    """Recursively coerce numpy scalars so configs/specs journal cleanly
    (and compare equal against their JSON round-trip on replay)."""
    if isinstance(obj, Mapping):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return [_jsonify(v) for v in obj.tolist()]
    return obj


#: per-process workload cache for process-pool slots (keyed by wl spec)
_WL_CACHE: Dict[tuple, Any] = {}


def _eval_segment(payload: Dict[str, Any]) -> Dict[str, Any]:
    """One simulator evaluation segment (module-level: process-picklable).

    Thread pools ship the prebuilt workload object; process pools ship the
    spec tuple and build/cache per worker (builds are deterministic)."""
    wl = payload.get("workload")
    if wl is None:
        key = tuple(payload["wl_spec"])
        wl = _WL_CACHE.get(key)
        if wl is None:
            wl = make_workload(key[0], key[1], threads=key[2],
                               scale=key[3], seed=key[4])
            _WL_CACHE[key] = wl
    out = run_simulation_segment(
        wl, payload["engine"], [payload["config"]],
        machine=payload["machine"],
        fast_slow_ratio=payload["fast_slow_ratio"],
        seeds=payload["seed"], sampler=payload["sampler"],
        fast_capacity_pages=payload["fast_capacity_pages"],
        crn=payload["crn"], batch_offset=payload["batch_offset"],
        epoch_start=payload["lo"], epoch_stop=payload["hi"],
        carry=payload["carry"], return_carry=payload["return_carry"],
        device=payload["device"], backend=payload["backend"],
        exact_select=payload["exact_select"])
    return {"wall_ms": out["wall_ms"][:, 0], "carry": out["carry"]}


def _eval_objective(objective: Callable[[Mapping[str, Any]], float],
                    config: Mapping[str, Any]) -> Dict[str, Any]:
    """Custom user objective evaluation."""
    return {"value": float(objective(config))}


@dataclasses.dataclass
class AsyncTuningResult(TuningResult):
    """A :class:`~repro_torch.core.bo.tuner.TuningResult` plus the async
    service's receipts: the full trial table, slot utilization and ASHA
    savings."""

    slots: int = 1
    scheduler: Optional[str] = None
    #: trial-table rows (:meth:`Trial.to_row`), creation order
    trials: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    max_epochs: int = 0
    #: sum of trials' committed epoch budgets (semantic work; the ASHA
    #: savings receipt compares this against budget * max_epochs)
    epochs_committed: int = 0
    #: epochs actually simulated this run (resumed trials and prefix
    #: re-runs differ from epochs_committed)
    epochs_evaluated: int = 0
    busy_s: float = 0.0                 # summed slot occupancy
    makespan_s: float = 0.0             # submit-to-last-commit wall clock
    journal_path: Optional[str] = None
    resumed: bool = False
    #: fleet receipt (:meth:`FleetExecutor.stats`): re-issue counts,
    #: worker deaths/respawns, re-issue overhead, time-to-recover, the
    #: workers' kernel launches
    fleet: Optional[Dict[str, Any]] = None

    @property
    def utilization(self) -> float:
        """Mean busy fraction of the evaluation slots."""
        return self.busy_s / max(self.slots * self.makespan_s, 1e-12)

    @property
    def asha_epochs_saved_frac(self) -> float:
        """Fraction of full-budget epoch work the scheduler skipped."""
        full = self.budget * max(self.max_epochs, 1)
        return 1.0 - self.epochs_committed / max(full, 1)

    @property
    def n_failed(self) -> int:
        return sum(1 for t in self.trials if t["state"] == FAILED)

    @property
    def n_stopped_early(self) -> int:
        return sum(1 for t in self.trials
                   if t["state"] == TERMINATED
                   and t["epochs_run"] < self.max_epochs)

    @property
    def best_row(self) -> Dict[str, Any]:
        """The incumbent: best fully-evaluated trial (extrapolated values
        of ASHA-stopped trials never claim the incumbency)."""
        full = [t for t in self.trials
                if t["state"] == TERMINATED
                and t["epochs_run"] >= self.max_epochs
                and t["value"] is not None]
        if not full:
            raise ValueError("study produced no fully-evaluated trial")
        return min(full, key=lambda t: (t["value"], t["index"]))

    @property
    def best(self) -> Observation:
        row = self.best_row
        return Observation(dict(row["config"]), float(row["value"]))


class TuneService:
    """One asynchronous tuning study; see the module docstring.

    Built and run by ``Study.tune(executor="async"|"fleet")`` -- not
    usually constructed directly.
    """

    def __init__(self, study, *, budget: int = 100, slots: int = 1,
                 scheduler: Optional[str] = None, seed: int = 0,
                 optimizer: str = "smac", n_init: int = 20,
                 random_prob: float = 0.20,
                 space: Optional[KnobSpace] = None,
                 surrogate: Optional[str] = None,
                 acquisition: Optional[str] = None,
                 objective: Optional[Callable] = None,
                 journal: Optional[str] = None, resume: bool = False,
                 pool: str = "thread", eta: int = 4,
                 window: Optional[int] = None,
                 verbose: bool = False,
                 executor: str = "local", workers: Optional[int] = None,
                 retries: int = 1, timeout_s: Optional[float] = None,
                 faults: FaultPlan = NO_FAULTS,
                 heartbeat_s: Optional[float] = None,
                 lease_deadline: Optional[int] = None,
                 max_respawns: Optional[int] = None,
                 fleet_spec=None):
        if scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}; expected "
                             f"one of {SCHEDULERS}")
        if scheduler is not None and objective is not None:
            raise ValueError(
                "scheduler='asha' needs partial-epoch objectives, which "
                "only the built-in simulator objective provides; drop "
                "objective= or use scheduler=None")
        if resume and journal is None:
            raise ValueError("resume=True requires journal=<path>")
        if executor not in EXECUTORS:
            raise ValueError(f"unknown executor {executor!r}; expected "
                             f"one of {EXECUTORS}")
        if fleet_spec is not None and executor != "fleet":
            raise ValueError("fleet_spec= requires executor='fleet'")
        if executor == "fleet":
            from .coordinator import FLEET_POOLS
            if workers is not None:
                slots = int(workers)
            if fleet_spec is not None:
                # the spec is the deployment artifact: it fixes the pool
                # (socket), the worker count and the heartbeat/lease
                # parameters the workers were launched with
                pool = "socket"
                slots = fleet_spec.workers
                if heartbeat_s is None:
                    heartbeat_s = fleet_spec.heartbeat_s
                if lease_deadline is None:
                    lease_deadline = fleet_spec.lease_deadline
            elif pool not in FLEET_POOLS:
                pool = "process"  # fleet workers are remote by definition
        self.study = study
        self.spec = study.spec
        self.budget = int(budget)
        self.slots = int(slots)
        # the ask-ahead window: refills trigger whenever a slot would
        # otherwise idle (outstanding < slots) and top the window up, so a
        # window larger than slots amortizes several asks into ONE
        # ask_batch call (one surrogate fit) without ever letting a slot
        # drain.  window == slots (the default) asks exactly as the
        # synchronous loop does at slots=1.
        self.window = max(self.slots, int(window) if window is not None
                          else self.slots)
        self.scheduler_name = scheduler
        self.seed = int(seed)
        self.pool = pool
        self.executor_kind = executor
        self.verbose = verbose
        self.objective = objective
        self.retries = int(retries)
        self.timeout_s = timeout_s
        #: injected worker faults (the fleet's workers apply them; local
        #: slots inject none)
        self.faults = faults if faults is not None else NO_FAULTS
        self.heartbeat_s = heartbeat_s
        self.lease_deadline = lease_deadline
        self.max_respawns = max_respawns
        self.fleet_spec = fleet_spec
        # fleet workers (and process slots) evaluate in other processes, so
        # units ship the workload spec tuple rather than the built object
        self._ship_spec = pool in ("process", "socket")
        self.crn = bool(self.spec.options.crn)
        self.space = space if space is not None \
            else get_space(self.spec.engine.name)
        if optimizer == "smac":
            self.optimizer = SMACOptimizer(
                self.space, seed=seed, n_init=n_init,
                random_prob=random_prob, surrogate=surrogate,
                acquisition=acquisition, device=self.spec.options.device)
        elif optimizer == "random":
            self.optimizer = RandomSearch(self.space, seed=seed)
        else:
            raise ValueError(f"unknown optimizer {optimizer!r}")
        self.optimizer_name = optimizer
        self.workload = study.workload()
        self.max_epochs = int(self.workload.n_epochs)
        self.sched = ASHAScheduler(self.max_epochs, eta=eta) \
            if scheduler == "asha" else None
        self.journal_path = journal
        self.journal = StudyJournal(journal, resume=resume) \
            if journal is not None else None
        self.resumed = bool(resume)
        # header params journaled for the replay-divergence guard (the
        # reference's keys and values)
        self._header = {
            "event": "study", "version": VERSION,
            "spec": _jsonify(self.spec.to_dict()),
            "budget": self.budget, "slots": self.slots,
            "window": self.window, "scheduler": scheduler,
            "rung_epochs": list(self.sched.rung_epochs) if self.sched
            else [self.max_epochs],
            "eta": self.sched.eta if self.sched else None,
            "optimizer": optimizer, "opt_seed": self.seed,
            "n_init": int(n_init), "random_prob": float(random_prob),
            "custom_objective": objective is not None,
            "executor": self.executor_kind, "retries": self.retries,
            # the lease deadline is a heartbeat COUNT (wall-clock-free);
            # None defers to the coordinator default
            "lease_deadline": self.lease_deadline,
            "timeout_s": self.timeout_s,
        }
        self._machine = study.machine
        opts = self.spec.options
        # promoted trials resume from their rung's host carry; the compiled
        # epoch loop checkpoints every engine, sampler and size it runs
        # (the numpy loop none: its units re-run [0, hi)).  Not
        # under the fleet: a rung unit re-derives [0, hi) from scratch
        # (exact: segmented equals unsegmented bitwise), which keeps each
        # unit a pure function of (config, hi) -- re-issue and
        # first-commit-wins compose with promotion unchanged -- and keeps
        # result frames small (a carry holds per-page arrays)
        self._can_checkpoint = objective is None and \
            opts.backend == "torch" and executor != "fleet" and \
            engine_torch.supports(self.spec.engine.name, opts.sampler,
                                  self.workload.n_pages)
        # bookkeeping
        self._units: Dict[int, Dict[str, Any]] = {}
        self._trials: List[Trial] = []
        self._groups: Dict[int, Dict[str, Any]] = {}
        self._next_group = 0
        self._asked = 0
        self._default_value: Optional[float] = None
        self._epochs_evaluated = 0
        self.executor = None

    # -- unit construction -------------------------------------------------
    def _segment_payload(self, config, lo: int, hi: int, carry
                         ) -> Dict[str, Any]:
        opts = self.spec.options
        wl = self.workload
        p = {
            "engine": self.spec.engine.name, "config": dict(config),
            "machine": self._machine,
            "fast_slow_ratio": self.spec.fast_slow_ratio,
            "seed": opts.seed, "sampler": opts.sampler,
            "fast_capacity_pages": self.spec.fast_capacity_pages,
            "backend": opts.backend, "crn": opts.crn, "batch_offset": 0,
            "exact_select": opts.exact_select,
            "lo": lo, "hi": hi, "carry": carry,
            "return_carry": self._can_checkpoint, "device": opts.device,
        }
        if self._ship_spec:
            p["wl_spec"] = (wl.name, wl.input_name, wl.threads, wl.scale,
                            wl.seed)
        else:
            p["workload"] = wl
        return p

    def _submit_unit(self, unit: Dict[str, Any]) -> None:
        """Enqueue one work unit, consulting the journal's replay cache:
        cache hits hold their canonical commit slot without occupying an
        evaluation slot."""
        ex = self.executor
        t: Optional[Trial] = unit.get("trial")
        if self.journal is not None and self.journal.replaying:
            if t is None:
                hit = self.journal.lookup("default")
                if hit is not None:
                    unit["cached"] = True
                    unit["seq"] = ex.submit_ready(
                        {"cached_value": hit["value"]})
                    self._units[unit["seq"]] = unit
                    return
            else:
                # the FIRST unconsumed event at (trial, epochs) decides the
                # unit's replayed fate: a ``retry`` precedes the eventual
                # ``eval``/``fail`` at the same epochs, so an errored
                # attempt replays its error (and re-journals the retry at
                # commit) before the resubmitted twin finds the final value
                hit = self.journal.lookup_first(
                    ("retry", "eval", "fail"), trial=t.index,
                    epochs=unit["hi"])
                if hit is not None:
                    unit["cached"] = True
                    if hit["event"] == "eval":
                        unit["seq"] = ex.submit_ready(
                            {"cached_value": hit["value"]})
                    else:
                        unit["seq"] = ex.submit_ready(
                            {"error": hit["error"]})
                    self._units[unit["seq"]] = unit
                    return
        config = self.space.default_config() if t is None else t.config
        if self.objective is not None:
            seq = ex.submit(_eval_objective, self.objective, config)
        else:
            lo, hi = unit["lo"], unit["hi"]
            carry = None
            if t is not None and self._can_checkpoint and \
                    t.checkpoint is not None and t.epochs_run == lo:
                carry = t.checkpoint
            if carry is None and lo != 0:
                # no usable checkpoint (a resumed trial whose earlier rungs
                # were cache hits): re-run the prefix
                unit["lo"] = lo = 0
            seq = ex.submit(_eval_segment,
                            self._segment_payload(config, lo, hi, carry))
        unit["seq"] = seq
        self._units[seq] = unit

    def _start_trial_unit(self, t: Trial, hi: int) -> None:
        t.advance(RUNNING)
        self._submit_unit({"trial": t, "rung": t.rung,
                           "lo": t.epochs_run, "hi": hi})

    def _rung_budget(self, rung: int) -> int:
        return self.sched.rung_epochs[rung] if self.sched else self.max_epochs

    # -- the ask-ahead window ---------------------------------------------
    def _refill(self) -> None:
        if self.executor.outstanding >= self.slots:
            return  # every slot is busy; don't ask on stale information
        m = min(self.window - self.executor.outstanding,
                self.budget - self._asked)
        if m <= 0:
            return
        cfgs = self.optimizer.ask_batch(m)
        gid = self._next_group
        self._next_group += 1
        members: List[Trial] = []
        for cfg in cfgs:
            cfg = _jsonify(cfg)
            t = Trial(index=self._asked, config=dict(cfg),
                      encoded=self.space.encode(cfg),
                      spec=self._header["spec"],
                      seed=int(self.spec.options.seed), batch_offset=0,
                      group=gid)
            self._asked += 1
            self._trials.append(t)
            members.append(t)
            self._journal({"event": "ask", "trial": t.index, "group": gid,
                           "config": t.config})
        self._groups[gid] = {"members": members, "done": 0}
        for t in members:
            self._start_trial_unit(t, self._rung_budget(0))

    # -- commits -----------------------------------------------------------
    def _journal(self, event: Dict[str, Any]) -> Dict[str, Any]:
        if self.journal is None:
            return event
        return self.journal.append(event)

    def _journal_history(self, seq: int, unit: Dict[str, Any]) -> None:
        """Journal the unit's fleet lease history (lease/expire/reissue) at
        its commit point -- the only place those events are deterministic.
        Live units re-generated their histories and append strictly; a
        replay cache hit never re-executed, so its recorded history is
        adopted verbatim."""
        if unit.get("cached"):
            if self.journal is not None:
                self.journal.consume_history(HISTORY_EVENTS, unit=seq)
            return
        for ev in self.executor.take_history(seq):
            self._journal(ev)

    def _commit(self, seq: int, result: Dict[str, Any]) -> None:
        unit = self._units.pop(seq)
        self._journal_history(seq, unit)
        t: Optional[Trial] = unit.get("trial")
        if t is None:  # the default-config baseline
            if "error" in result:
                raise RuntimeError(
                    "default-config baseline evaluation failed:\n"
                    + result["error"])
            v = result["cached_value"] if "cached_value" in result \
                else self._result_value(None, unit, result)
            ev = self._journal({"event": "default", "value": v})
            self._default_value = float(ev.get("value", v))
            self._refill()
            return
        t.wall_s += float(result.get("slot_s", 0.0))
        if "error" in result:
            if t.attempt < self.retries:
                # bounded retry: one transient fault must not discard the
                # trial's budget.  The retry is a journaled, deterministic
                # event -- replay reproduces it -- and the trial stays
                # RUNNING while its segment is resubmitted.
                t.attempt += 1
                self._journal({"event": "retry", "trial": t.index,
                               "attempt": t.attempt, "epochs": unit["hi"],
                               "error": result["error"]})
                self._submit_unit({"trial": t, "rung": t.rung,
                                   "lo": t.epochs_run, "hi": unit["hi"]})
                self._refill()
                return
            t.advance(FAILED)
            t.error = result["error"]
            t.epochs_run = unit["hi"]
            self._journal({"event": "fail", "trial": t.index,
                           "epochs": unit["hi"], "error": t.error})
            self._group_member_done(t, tell=False)
            self._refill()
            return
        if "cached_value" in result:
            value = float(result["cached_value"])
        else:
            value = self._result_value(t, unit, result)
        t.epochs_run = unit["hi"]
        t.value = value
        ev = self._journal({"event": "eval", "trial": t.index,
                            "epochs": t.epochs_run, "value": value})
        value = t.value = float(ev.get("value", value))
        if self.sched is not None and not self.sched.is_final(t.rung):
            decision = self.sched.report(t.rung, t.index, value)
            self._journal({"event": "rung", "trial": t.index,
                           "rung": t.rung, "decision": decision})
            if decision == PROMOTE:
                t.advance(PAUSED)
                t.rung += 1
                self._start_trial_unit(t, self._rung_budget(t.rung))
            else:
                # extrapolate the partial value to full budget before the
                # tell: a trial stopped at 1/4 budget must not enter the
                # surrogate as a 4x-faster config
                t.advance(TERMINATED)
                t.told_value = value * (self.max_epochs / t.epochs_run)
                self._group_member_done(t, tell=True)
        else:
            t.advance(TERMINATED)
            t.told_value = value
            self._group_member_done(t, tell=True)
        self._refill()

    def _result_value(self, t: Optional[Trial], unit: Dict[str, Any],
                      result: Dict[str, Any]) -> float:
        """Fold a fresh evaluation into the trial and compute its committed
        value canonically (independent of segmentation)."""
        if "value" in result:  # custom objective
            return float(result["value"])
        wall = np.asarray(result["wall_ms"], dtype=np.float64)
        self._epochs_evaluated += len(wall)
        if t is None:
            return float(wall.sum() / 1e3)
        if unit["lo"] == 0:
            t.epoch_wall_ms = [wall]
        else:
            t.epoch_wall_ms.append(wall)
        t.checkpoint = result.get("carry")
        return t.value_at(unit["hi"])

    # -- CRN-group tells ---------------------------------------------------
    def _group_member_done(self, t: Trial, tell: bool) -> None:
        """Buffer a finished group member; once the whole CRN group has
        landed, commit its tells in trial-index order.  FAILED members are
        excluded from the tell but still complete the group."""
        g = self._groups[t.group]
        g["done"] += 1
        if g["done"] < len(g["members"]):
            return
        live = [m for m in g["members"] if m.state == TERMINATED]
        if live:
            if len(g["members"]) == 1:
                m = live[0]
                self.optimizer.tell(m.config, m.told_value)
            else:
                self.optimizer.tell_batch(
                    [m.config for m in live],
                    [m.told_value for m in live], crn=self.crn)
            for m in live:
                self._journal({"event": "tell", "trial": m.index,
                               "group": t.group, "value": m.told_value})
                if self.verbose:
                    best = min(o.value for o in
                               self.optimizer.observations)
                    print(f"  trial {m.index + 1:4d}/{self.budget}: "
                          f"f={m.told_value:9.2f}s best={best:9.2f}s",
                          flush=True)
        del self._groups[t.group]

    # -- the run loop ------------------------------------------------------
    def run(self) -> AsyncTuningResult:
        t0 = time.time()
        self._journal(self._header)
        if self.executor_kind == "fleet":
            from .coordinator import FleetExecutor
            kw: Dict[str, Any] = {"timeout_s": self.timeout_s,
                                  "faults": self.faults,
                                  "device": self.spec.options.device}
            if self.heartbeat_s is not None:
                kw["heartbeat_s"] = self.heartbeat_s
            if self.lease_deadline is not None:
                kw["lease_deadline"] = self.lease_deadline
            if self.max_respawns is not None:
                kw["max_respawns"] = self.max_respawns
            if self.fleet_spec is not None:
                kw["fleet_spec"] = self.fleet_spec  # never journaled: the
                # spec carries the fleet's shared auth key
            self.executor = FleetExecutor(self.slots, pool=self.pool, **kw)
        else:
            self.executor = TrialExecutor(self.slots, self.pool,
                                          timeout_s=self.timeout_s)
        try:
            mk0 = time.perf_counter()
            # the default-config baseline evaluates first, exactly like the
            # synchronous loop's default_value (full budget, never told)
            self._submit_unit({"trial": None, "lo": 0,
                               "hi": self.max_epochs})
            self._refill()
            while self.executor.outstanding > 0:
                seq, result = self.executor.pop_next()
                self._commit(seq, result)
            makespan = time.perf_counter() - mk0
            rows = [t.to_row() for t in self._trials]
            result = AsyncTuningResult(
                engine=self.spec.engine.name, scenario=self.study.key,
                budget=self.budget,
                history=list(self.optimizer.observations),
                default_value=float(self._default_value),
                wall_s=time.time() - t0, round_times=[],
                slots=self.slots, scheduler=self.scheduler_name,
                trials=rows, max_epochs=self.max_epochs,
                epochs_committed=sum(r["epochs_run"] for r in rows
                                     if r["state"] == TERMINATED),
                epochs_evaluated=self._epochs_evaluated,
                busy_s=self.executor.busy_s, makespan_s=makespan,
                journal_path=self.journal_path, resumed=self.resumed,
                fleet=self.executor.stats()
                if self.executor_kind == "fleet" else None)
            best = result.best_row
            self._journal({
                "event": "done", "best_trial": best["index"],
                "best_value": best["value"],
                "n_failed": result.n_failed,
                "n_stopped_early": result.n_stopped_early})
            return result
        finally:
            self.executor.close()
            if self.journal is not None:
                self.journal.close()
