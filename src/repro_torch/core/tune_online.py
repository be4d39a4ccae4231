"""Online re-tuning under workload drift: sliding-window SMAC with
phase-change detection, warm restarts and a hysteresis/dwell switch guard
(the reference package's tuner, on the port's epoch loop).

The static tuner (:class:`~repro_torch.core.bo.tuner.TuningSession`)
answers "what is the best config for THIS trace"; under drift
(:mod:`repro_torch.core.drift`)
that question has a different answer per phase, and the related work says
the hard part is *re-adapting without thrashing* — Jenga's headline failure
mode is oscillating between configs on noisy feedback.  This module is the
tuner half of the drift story:

**The window loop.**  Time is cut into windows of ``window_epochs`` epochs.
Each window runs ONE batched segment
(:func:`~repro_torch.core.simulator.run_simulation_segment`, ``crn=True``,
on the spec's device) whose batch is ``[deployed] + candidates``: row 0 is
the config the system is actually running, rows 1..q are SMAC's
suggestions.  All rows start from the *deployed* system's checkpoint (the
host carry) at the window start --
:func:`~repro_torch.core.engine_torch.broadcast_carry_row` row 0 --
so under common random numbers every candidate's window wall answers "what
if we had switched at this boundary" as a paired counterfactual, at zero
extra trace cost.  The deployed system always advances along row 0: a
config switch changes what row 0 *runs* next window, from the state the old
config left behind — exactly like a real system flipping knobs mid-run.
The batch width is fixed: short budgets pad the batch with deployed copies
rather than shrink it, so every window runs one shape.

**Phase-change detection.**  Two detectors, OR'd:

* *sampled-histogram divergence* (primary): the total-variation distance
  between consecutive windows' normalized per-page access histograms
  (:func:`~repro_torch.core.drift.histogram_divergence` over the segment
  trace the epoch loop hands back).  Exactly 0 between same-phase windows of
  the procedural workloads, so the default threshold has real margin.
* *surrogate-residual blowup*: the deployed config's measured window wall
  vs. the forest's prediction — a z-score above ``resid_z`` with relative
  deviation above ``resid_rel`` means the model of the current phase has
  stopped explaining reality.

**Warm restart.**  On detection the optimizer is REPLACED — a fresh
:class:`~repro_torch.core.bo.smac.SMACOptimizer` whose ``seed_configs`` are the
prior optimizer's elites (current deployed first, then the top-``k``
distinct configs by observed value).  The new phase's forest is therefore
fit on re-evaluations of previously good configs instead of starting
blind, and stale observations from the old phase cannot mislead it.

**Hysteresis/dwell guard.**  A switch is applied only if the best
candidate beat the deployed config by more than ``hysteresis`` (relative)
AND at least ``dwell_windows`` windows have passed since the last switch.
Near-ties and noise cannot flip the config back and forth: the guard makes
config-thrashing structurally impossible rather than merely unlikely
(``guard_blocks`` counts the suppressions; ``thrash_events`` counts
A→B→A reverts within ``2 * dwell_windows`` and is asserted zero by the
tests and chip_smoke.py).

**Journal & resume.**  With ``journal=<path>`` every window decision is
recorded through
:class:`~repro_torch.core.tune_service.journal.StudyJournal`.
The control loop is a deterministic function of its parameters and the
epoch loop is bitwise-deterministic, so ``resume=True`` simply
re-runs the loop (segments are cheap; the carry is NOT journaled) while
the journal *asserts* every replayed decision matches the recorded one,
then appends past the prefix — a resumed journal is byte-identical to an
uninterrupted run's, the same contract the async tune service pins.

Entry point: ``Study.tune(online=True, window_epochs=..., ...)`` —
see :meth:`repro_torch.core.study.Study.tune`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from . import engine_torch
from .drift import histogram_divergence
from .bo.smac import SMACOptimizer
from .knobs import SPACES, KnobSpace
from .simulator import run_simulation_segment

Config = Dict[str, Any]

#: journal schema version for the online-tuning event stream
ONLINE_JOURNAL_VERSION = 1


def _py(value):
    """Numpy scalar -> plain Python (JSON-journalable, exact round trip)."""
    return value.item() if hasattr(value, "item") else value


def _py_config(config: Mapping[str, Any]) -> Config:
    return {k: _py(v) for k, v in config.items()}


def _config_key(config: Mapping[str, Any]):
    return tuple(sorted(config.items()))


@dataclasses.dataclass
class OnlineWindow:
    """One window's decision record (mirrors the journaled event)."""

    index: int
    epoch_lo: int
    epoch_hi: int
    deployed: Config
    candidates: List[Config]
    deployed_wall_ms: float
    candidate_walls_ms: List[float]
    divergence: Optional[float]
    residual_z: Optional[float]
    detect: bool
    cause: Optional[str]
    switched: bool
    blocked: bool
    switched_to: Optional[Config] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class OnlineTuningResult:
    """Timeline + receipts of one online-tuning run.

    ``total_wall_ms`` is the DEPLOYED system's cumulative simulated wall —
    row 0 summed over every window, including the mis-configured epochs
    before each re-adaptation — the quantity to compare against a static
    config's wall on the same trace.
    """

    scenario: str
    windows: List[OnlineWindow]
    total_wall_ms: float
    switches: int
    detections: int
    guard_blocks: int
    thrash_events: int
    evals_used: int
    budget: int
    final_config: Config
    wall_s: float

    @property
    def deployed_walls(self) -> np.ndarray:
        """Per-window deployed wall (ms), the readaptation timeline."""
        return np.array([w.deployed_wall_ms for w in self.windows])

    @property
    def switch_windows(self) -> List[int]:
        return [w.index for w in self.windows if w.switched]

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["windows"] = [w.to_dict() for w in self.windows]
        return d


class OnlineTuner:
    """The sliding-window control loop; drive via :meth:`run`.

    Deterministic in ``(study spec, seed, loop parameters)`` — no wall
    clock or unseeded randomness feeds any decision, which is what makes
    the journal's byte-identical kill/resume contract possible.
    """

    def __init__(self, study, *, window_epochs: int, batch_size: int = 6,
                 budget: int = 10 ** 9, seed: int = 0, n_init: int = 8,
                 hysteresis: float = 0.05, dwell_windows: int = 2,
                 div_threshold: float = 0.25, resid_z: float = 4.0,
                 resid_rel: float = 0.15, elites: int = 3,
                 space: Optional[KnobSpace] = None,
                 journal: Optional[str] = None, resume: bool = False,
                 verbose: bool = False):
        if window_epochs < 1:
            raise ValueError(
                f"window_epochs must be >= 1, got {window_epochs}")
        if batch_size < 1:
            raise ValueError(
                f"online tuning needs batch_size >= 1 candidate per "
                f"window, got {batch_size}")
        if not 0.0 <= hysteresis < 1.0:
            raise ValueError(
                f"hysteresis must be in [0, 1), got {hysteresis}")
        if dwell_windows < 1:
            raise ValueError(
                f"dwell_windows must be >= 1, got {dwell_windows}")
        opts = study.spec.options
        if opts.backend != "torch":
            raise ValueError(
                "online tuning runs candidate batches as CRN counterfactual"
                " segments, which requires the compiled backend: construct "
                "the study with SimOptions(backend='torch', crn=True)")
        if not opts.crn:
            raise ValueError(
                "online tuning runs candidate batches as CRN counterfactual"
                " segments: construct the study with SimOptions(crn=True)")
        self.study = study
        self.window_epochs = int(window_epochs)
        self.q = int(batch_size)
        self.budget = int(budget)
        self.seed = int(seed)
        self.n_init = int(n_init)
        self.hysteresis = float(hysteresis)
        self.dwell_windows = int(dwell_windows)
        self.div_threshold = float(div_threshold)
        self.resid_z = float(resid_z)
        self.resid_rel = float(resid_rel)
        self.n_elites = int(elites)
        self.space = space if space is not None \
            else SPACES.get(study.spec.engine.name)
        if self.space is None:
            raise ValueError(
                f"engine {study.spec.engine.name!r} has no registered knob "
                f"space; online tuning needs one (see repro_torch.core.knobs)")
        self.journal_path = journal
        self.resume = resume
        self.verbose = verbose

    # -- optimizer lifecycle ----------------------------------------------
    def _fresh_optimizer(self, phase_idx: int,
                         prior: Optional[SMACOptimizer],
                         deployed: Config) -> SMACOptimizer:
        """Phase ``phase_idx``'s optimizer; warm-restarted from ``prior``."""
        seeds: List[Config] = []
        if prior is not None:
            seeds.append(dict(deployed))
            seen = {_config_key(deployed)}
            for obs in sorted(prior.observations, key=lambda o: o.value):
                k = _config_key(obs.config)
                if k not in seen:
                    seen.add(k)
                    seeds.append(dict(obs.config))
                if len(seeds) >= 1 + self.n_elites:
                    break
        return SMACOptimizer(
            self.space, seed=self.seed + 1000 * phase_idx,
            n_init=self.n_init if prior is None
            else min(self.n_init, 2 * self.q),
            start_with_default=prior is None,
            seed_configs=seeds or None,
            device=self.study.spec.options.device)

    # -- detection ---------------------------------------------------------
    @staticmethod
    def _window_hist(out: Mapping[str, Any]) -> Optional[np.ndarray]:
        reads, writes = out.get("trace_reads"), out.get("trace_writes")
        if reads is None:
            return None
        h = (np.asarray(reads, dtype=np.float64).sum(axis=0)
             + np.asarray(writes, dtype=np.float64).sum(axis=0))
        s = h.sum()
        return h / s if s > 0 else h

    def _residual_z(self, opt: SMACOptimizer, deployed: Config,
                    wall: float) -> Optional[float]:
        if len(opt.observations) < max(4, self.q + 1):
            return None
        mean, std = opt.surrogate().predict_batch(
            self.space.encode(deployed)[None, :])
        resid = float(wall) - float(mean[0])
        if abs(resid) <= self.resid_rel * max(abs(float(mean[0])), 1e-9):
            return 0.0  # inside the relative floor: never a detection
        return resid / max(float(std[0]), 1e-9)

    # -- the loop ----------------------------------------------------------
    def run(self) -> OnlineTuningResult:
        from .tune_service.journal import StudyJournal

        study, spec, opts = self.study, self.study.spec, \
            self.study.spec.options
        workload = study.workload()
        engine = spec.engine.name
        if not engine_torch.supports(engine, opts.sampler,
                                     workload.n_pages):
            raise ValueError(
                f"online tuning needs segment checkpoints, but the epoch "
                f"loop does not cover engine={engine!r}, "
                f"sampler={opts.sampler!r}, n_pages={workload.n_pages} "
                f"(see engine_torch.supports)")
        W = self.window_epochs
        n_epochs = workload.n_epochs
        n_windows = -(-n_epochs // W)
        journal = StudyJournal(self.journal_path, resume=self.resume) \
            if self.journal_path else None
        t0 = time.perf_counter()

        deployed = _py_config(spec.engine.config)
        prev_deployed: Optional[Config] = None
        opt = self._fresh_optimizer(0, None, deployed)
        windows: List[OnlineWindow] = []
        carry = None
        prev_hist: Optional[np.ndarray] = None
        last_switch = -self.dwell_windows  # first switch is dwell-eligible
        total_wall = 0.0
        switches = detections = guard_blocks = thrash = evals = 0

        if journal is not None:
            journal.append({
                "event": "online", "version": ONLINE_JOURNAL_VERSION,
                "spec": spec.to_dict(), "window_epochs": W,
                "q": self.q, "budget": self.budget, "seed": self.seed,
                "n_init": self.n_init, "hysteresis": self.hysteresis,
                "dwell_windows": self.dwell_windows,
                "div_threshold": self.div_threshold,
                "resid_z": self.resid_z, "resid_rel": self.resid_rel,
                "elites": self.n_elites})

        for k in range(n_windows):
            lo, hi = k * W, min((k + 1) * W, n_epochs)
            n_ask = min(self.q, max(0, self.budget - evals))
            cands = [_py_config(c) for c in opt.ask_batch(n_ask)] \
                if n_ask else []
            # pad to the fixed batch width: every window runs one shape
            batch = [deployed] + cands \
                + [dict(deployed)] * (self.q - len(cands))
            seg_carry = None if carry is None else \
                engine_torch.broadcast_carry_row(carry, 0, len(batch))
            out = run_simulation_segment(
                workload, engine, batch, study.machine,
                fast_slow_ratio=spec.fast_slow_ratio, seeds=opts.seed,
                sampler=opts.sampler,
                fast_capacity_pages=spec.fast_capacity_pages,
                crn=True, epoch_start=lo, epoch_stop=hi, carry=seg_carry,
                return_carry=True, device=opts.device,
                exact_select=opts.exact_select)
            carry = out["carry"]
            win_wall = np.asarray(out["wall_ms"]).sum(axis=0)
            dep_wall = float(win_wall[0])
            cand_walls = [float(v) for v in win_wall[1:1 + len(cands)]]
            total_wall += dep_wall
            # the optimizer and the residual detector see PER-EPOCH walls,
            # so a short final window stays comparable to full windows;
            # the journaled/cumulative walls stay raw sums
            per_epoch = win_wall / float(hi - lo)
            dep_pe = float(per_epoch[0])
            cand_pe = [float(v) for v in per_epoch[1:1 + len(cands)]]

            # detect BEFORE telling: the residual must test the forest as
            # it stood when this window started
            z = self._residual_z(opt, deployed, dep_pe)
            hist = self._window_hist(out)
            div = None if (prev_hist is None or hist is None) \
                else histogram_divergence(prev_hist, hist)
            causes = []
            if div is not None and div > self.div_threshold:
                causes.append("histogram")
            if z is not None and abs(z) > self.resid_z:
                causes.append("residual")
            detect = bool(causes)

            opt.tell_batch([deployed] + cands, [dep_pe] + cand_pe)
            evals += len(cands)

            if detect:
                detections += 1
                opt = self._fresh_optimizer(detections, opt, deployed)

            # hysteresis/dwell switch guard
            switched = blocked = False
            switched_to: Optional[Config] = None
            if cand_walls:
                best = int(np.argmin(cand_walls))
                improves = cand_walls[best] \
                    < dep_wall * (1.0 - self.hysteresis)
                if improves and k - last_switch >= self.dwell_windows:
                    if prev_deployed is not None \
                            and _config_key(cands[best]) == \
                            _config_key(prev_deployed) \
                            and k - last_switch <= 2 * self.dwell_windows:
                        thrash += 1  # A->B->A revert inside 2*dwell
                    prev_deployed = deployed
                    deployed = dict(cands[best])
                    switched_to = deployed
                    switched, last_switch = True, k
                    switches += 1
                elif improves:
                    blocked = True
                    guard_blocks += 1

            win = OnlineWindow(
                index=k, epoch_lo=lo, epoch_hi=hi,
                deployed=dict(batch[0]), candidates=cands,
                deployed_wall_ms=dep_wall, candidate_walls_ms=cand_walls,
                divergence=None if div is None else float(div),
                residual_z=None if z is None else float(z),
                detect=detect, cause="+".join(causes) or None,
                switched=switched, blocked=blocked, switched_to=switched_to)
            windows.append(win)
            if journal is not None:
                journal.append({"event": "window", **win.to_dict()})
            if self.verbose:
                print(f"[online] window {k:3d} [{lo:3d},{hi:3d}) "
                      f"wall={dep_wall:9.1f}ms div={div if div is None else round(div, 4)} "
                      f"{'DETECT ' + win.cause if detect else ''}"
                      f"{'SWITCH' if switched else ''}"
                      f"{'BLOCKED' if blocked else ''}")
            prev_hist = hist

        result = OnlineTuningResult(
            scenario=study.key, windows=windows,
            total_wall_ms=float(total_wall), switches=switches,
            detections=detections, guard_blocks=guard_blocks,
            thrash_events=thrash, evals_used=evals, budget=self.budget,
            final_config=dict(deployed),
            wall_s=time.perf_counter() - t0)
        if journal is not None:
            journal.append({
                "event": "done", "windows": n_windows,
                "switches": switches, "detections": detections,
                "guard_blocks": guard_blocks, "thrash": thrash,
                "evals": evals, "total_wall_ms": float(total_wall),
                "final_config": dict(deployed)})
            journal.close()
        return result
