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
                 crn: bool = False, surrogate: Optional[str] = None,
                 acquisition: Optional[str] = None, device="cuda"):
        """``space`` overrides the engine's knob space; ``surrogate`` and
        ``acquisition`` pick SMAC's forest grower and scoring pipeline
        (:class:`~repro_torch.core.bo.smac.SMACOptimizer`); ``device`` is
        where the fused pipeline scores each pool (the card for a CUDA
        device, numpy on the host for the CPU)."""
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
                                           surrogate=surrogate,
                                           acquisition=acquisition,
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


def tune_scenario(engine: str, scenario, budget: int = 100, seed: int = 0,
                  optimizer: str = "smac", verbose: bool = False,
                  batch_size: int = 1, workers: int = 1,
                  sampler: str = "sparse", backend: str = "numpy",
                  ) -> TuningResult:
    """Deprecated wrapper -- use ``Study(spec).tune(budget, batch_size)``.

    ``batch_size=q > 1`` evaluates each optimizer round as one batched
    simulator pass (``sampler``/``workers``/``backend`` select its
    evaluation mode); ``batch_size=1`` is the paper-faithful sequential
    loop, on the elementwise sampler and the numpy backend.  The
    optimizer's model phase runs on the host.
    """
    from .._deprecation import warn_deprecated
    from ..specs import EngineSpec, ExperimentSpec, SimOptions, WorkloadSpec
    from ..study import Study
    warn_deprecated("repro_torch.core.bo.tuner.tune_scenario",
                    "Study(ExperimentSpec(...)).tune(budget, batch_size)")
    if batch_size <= 1 and (workers not in (1, None) or sampler != "sparse"
                            or backend != "numpy"):
        import warnings
        warnings.warn(
            "batch_size=1 runs the paper-faithful sequential loop; "
            "workers/sampler/backend only apply with batch_size > 1",
            stacklevel=2)
    if batch_size <= 1:  # the sequential loop always evaluated elementwise
        sampler, workers, backend = "elementwise", 1, "numpy"
    spec = ExperimentSpec(
        engine=EngineSpec(engine),
        workload=WorkloadSpec(scenario.workload, scenario.input_name,
                              threads=scenario.threads,
                              scale=scenario.scale),
        machine=scenario.machine, fast_slow_ratio=scenario.fast_slow_ratio,
        options=SimOptions(seed=scenario.seed, sampler=sampler,
                           workers=workers, backend=backend,
                           device="cuda" if backend == "torch" else "cpu"))
    return Study(spec).tune(budget=budget, batch_size=batch_size, seed=seed,
                            optimizer=optimizer, verbose=verbose)
