"""Tuning pipeline (§3.1): launch session -> evaluate -> update -> repeat.

:class:`TuningSession` wires an objective (a
:class:`~repro_torch.core.study.Study`'s simulator) to an optimizer and
records the full history, the incumbent trajectory and the
iterations-to-optimum statistics the paper reports ("SMAC finds the
best-performing configuration for GUPS within 10-16 iterations").

With ``batch_size=q > 1`` and a batched objective (a callable mapping a list
of configs to a list of values), each tuning iteration asks the
optimizer for a whole candidate batch and evaluates it in ONE vectorized
simulator pass — the history still contains exactly ``budget`` observations,
and ``batch_size=1`` reproduces the sequential loop bit-for-bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..knobs import Config, KnobSpace, get_space
from .smac import Observation, RandomSearch, SMACOptimizer


@dataclasses.dataclass
class TuningResult:
    engine: str
    scenario: str
    budget: int
    history: List[Observation]
    default_value: float
    wall_s: float
    #: per-round wall-clock breakdown: each entry has ``ask_s`` (suggestion,
    #: including the surrogate fit), ``fit_s`` (the surrogate-fit share of
    #: ask), ``eval_s`` (objective evaluation), ``tell_s`` and ``q``
    round_times: List[Dict[str, float]] = dataclasses.field(
        default_factory=list)

    @property
    def best(self) -> Observation:
        return min(self.history, key=lambda o: o.value)

    @property
    def optimizer_overhead_s(self) -> float:
        """Total ask+tell wall clock (everything that is not evaluation)."""
        return float(sum(r["ask_s"] + r["tell_s"] for r in self.round_times))

    @property
    def evaluation_s(self) -> float:
        return float(sum(r["eval_s"] for r in self.round_times))

    @property
    def overhead_fraction(self) -> float:
        """ask/tell overhead as a fraction of evaluation wall clock."""
        return self.optimizer_overhead_s / max(self.evaluation_s, 1e-12)

    @property
    def best_value(self) -> float:
        return self.best.value

    @property
    def improvement(self) -> float:
        """default/best execution-time ratio (the paper's headline metric)."""
        return self.default_value / self.best_value

    def incumbent_trajectory(self) -> np.ndarray:
        vals = np.array([o.value for o in self.history])
        return np.minimum.accumulate(vals)

    def iterations_to(self, target: float, rtol: float = 0.01) -> Optional[int]:
        """First iteration whose incumbent is within rtol of ``target``."""
        traj = self.incumbent_trajectory()
        hit = np.flatnonzero(traj <= target * (1.0 + rtol))
        return int(hit[0]) + 1 if len(hit) else None


class TuningSession:
    def __init__(self, engine: str, objective: Callable[[Config], float],
                 scenario_key: str = "", space: Optional[KnobSpace] = None,
                 optimizer: str = "smac", budget: int = 100, seed: int = 0,
                 n_init: int = 20, random_prob: float = 0.20,
                 batch_size: int = 1,
                 objective_batch: Optional[
                     Callable[[Sequence[Config]], Sequence[float]]] = None,
                 crn: bool = False, device="cuda"):
        """``space`` overrides the engine's knob space; ``device`` is where
        SMAC's model phase scores each pool (the card for a CUDA device,
        numpy on the host for the CPU)."""
        self.engine = engine
        self.space = space if space is not None else get_space(engine)
        self.objective = objective
        self.objective_batch = objective_batch
        self.scenario_key = scenario_key
        self.budget = budget
        self.batch_size = max(1, int(batch_size))
        #: the batched objective evaluates under common random numbers, so
        #: tell_batch(crn=True) debiases any re-evaluated config against its
        #: recorded value.  No incumbent control is planted: with the
        #: simulator's counter-based draws the noise is fixed given the
        #: spec seed (re-evaluations are bitwise-deterministic), so a
        #: control could never measure a nonzero offset and would only burn
        #: a budget slot.
        self.crn = bool(crn)
        if self.batch_size > 1 and objective_batch is None:
            # fall back to mapping the scalar objective over the batch
            self.objective_batch = lambda cfgs: [float(objective(c))
                                                 for c in cfgs]
        if optimizer == "smac":
            self.optimizer = SMACOptimizer(self.space, seed=seed,
                                           n_init=n_init,
                                           random_prob=random_prob,
                                           device=device)
        elif optimizer == "random":
            self.optimizer = RandomSearch(self.space, seed=seed)
        else:
            raise ValueError(f"unknown optimizer {optimizer!r}")

    def run(self, verbose: bool = False) -> TuningResult:
        t0 = time.time()

        def cb(i, cfg, val):
            if verbose:
                best = min(o.value for o in self.optimizer.observations)
                print(f"  iter {i + 1:3d}/{self.budget}: f={val:9.2f}s "
                      f"best={best:9.2f}s", flush=True)

        def fit_s() -> float:
            return float(getattr(self.optimizer, "fit_s", 0.0))

        round_times: List[Dict[str, float]] = []
        if self.batch_size > 1:
            default_value = float(
                self.objective_batch([self.space.default_config()])[0])
            done = 0
            while done < self.budget:
                q = min(self.batch_size, self.budget - done)
                fit0, ta = fit_s(), time.perf_counter()
                cfgs = self.optimizer.ask_batch(q)
                te = time.perf_counter()
                vals = [float(v) for v in self.objective_batch(cfgs)]
                tt = time.perf_counter()
                self.optimizer.tell_batch(cfgs, vals, crn=self.crn)
                tend = time.perf_counter()
                round_times.append({
                    "ask_s": te - ta, "fit_s": fit_s() - fit0,
                    "eval_s": tt - te, "tell_s": tend - tt, "q": float(q)})
                for j, (cfg, val) in enumerate(zip(cfgs, vals)):
                    cb(done + j, cfg, val)
                done += q
        else:
            # the sequential loop, with the per-round ask/eval/tell walls
            # recorded
            default_value = float(self.objective(self.space.default_config()))
            for i in range(self.budget):
                fit0, ta = fit_s(), time.perf_counter()
                cfg = self.optimizer.ask()
                te = time.perf_counter()
                val = float(self.objective(cfg))
                tt = time.perf_counter()
                self.optimizer.tell(cfg, val)
                tend = time.perf_counter()
                round_times.append({
                    "ask_s": te - ta, "fit_s": fit_s() - fit0,
                    "eval_s": tt - te, "tell_s": tend - tt, "q": 1.0})
                cb(i, cfg, val)
        return TuningResult(
            engine=self.engine, scenario=self.scenario_key,
            budget=self.budget,
            history=list(self.optimizer.observations),
            default_value=default_value, wall_s=time.time() - t0,
            round_times=round_times)

