"""Study: the typed front-end of the PyTorch port over simulate and tune.

* ``Study(spec).run()`` — simulate the spec's engine config (one
  :class:`~repro_torch.core.simulator.SimResult`); ``run(configs=[...])``
  pushes a candidate batch through one shared trace on the spec's device;
* ``Study(spec).tune(budget, batch_size)`` — SMAC-BO knob tuning
  (:class:`~repro_torch.core.bo.tuner.TuningSession`), one batched
  simulator pass per round when ``batch_size > 1``.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
queue item): ``sweep``, ``tune(executor="async"|"fleet")`` and
``tune(online=True)``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping, Optional, Sequence

from .bo.tuner import TuningResult, TuningSession
from .knobs import Config
from .simulator import Machine, SimResult, get_machine, run_simulation_batch
from .specs import ExperimentSpec
from .workloads import Workload, make_workload


class Study:
    """Typed front-end: one spec, two call patterns (run/tune)."""

    def __init__(self, spec: ExperimentSpec):
        if not isinstance(spec, ExperimentSpec):
            raise TypeError(f"expected ExperimentSpec, got {type(spec)!r}")
        self.spec = spec
        self.machine: Machine = get_machine(spec.machine)
        self._workload: Optional[Workload] = None

    @property
    def key(self) -> str:
        return self.spec.key

    def workload(self) -> Workload:
        """The spec's workload, built once per Study (builds are
        deterministic in the spec)."""
        if self._workload is None:
            wspec = self.spec.workload
            threads = wspec.threads if wspec.threads is not None \
                else self.machine.default_threads
            self._workload = make_workload(
                wspec.name, wspec.input_name, threads=threads,
                scale=wspec.scale, seed=self.spec.options.seed)
        return self._workload

    def run(self, configs: Optional[Sequence[Mapping[str, Any]]] = None
            ) -> "SimResult | List[SimResult]":
        """Simulate the spec (one ``SimResult``), or a candidate batch
        through one shared trace (a list, one result per config)."""
        opts = self.spec.options
        batch = [self.spec.engine.config] if configs is None \
            else [dict(c) for c in configs]
        results = run_simulation_batch(
            self.workload(), self.spec.engine.name, batch, self.machine,
            fast_slow_ratio=self.spec.fast_slow_ratio, seeds=opts.seed,
            sampler=opts.sampler, record_heatmap=opts.record_heatmap,
            heat_bins=opts.heat_bins,
            fast_capacity_pages=self.spec.fast_capacity_pages,
            crn=opts.crn, device=opts.device)
        return results[0] if configs is None else results

    def tune(self, budget: int = 100, batch_size: int = 1, seed: int = 0,
             optimizer: str = "smac", n_init: int = 20,
             random_prob: float = 0.20, verbose: bool = False,
             objective: Optional[Callable[[Config], float]] = None,
             objective_batch: Optional[
                 Callable[[Sequence[Config]], Sequence[float]]] = None,
             executor: str = "sync", online: bool = False) -> TuningResult:
        """SMAC-BO tuning of the spec's engine knobs (§3.1).

        ``seed`` seeds the optimizer; the simulation seed stays
        ``spec.options.seed``.  ``batch_size=q > 1`` evaluates each round
        as one batched simulator pass; with ``spec.options.crn`` every
        candidate of a round sees the same monitoring noise, so the
        optimizer's within-batch comparisons are paired.
        ``optimizer="random"`` is the paper's unguided baseline.

        ``objective`` (``config -> float``, lower is better) replaces the
        simulator with a custom objective — e.g. the serving score of a
        ``TieredKVCache`` traffic replay
        (:func:`repro_torch.serving_replay.serving_objective`) — while the
        spec still names what is tuned (the engine resolves the knob
        space).  ``objective_batch`` (``[config] -> [float]``) is its
        vectorized counterpart for ``batch_size > 1``; without it the
        scalar objective is mapped over each round.
        """
        if online:
            raise NotImplementedError(
                "online re-tuning is not ported yet (ROADMAP queue 1, "
                "item 'Async, fleet and online tuning')")
        if executor in ("async", "fleet"):
            raise NotImplementedError(
                f"executor={executor!r} is not ported yet (ROADMAP queue 1, "
                "item 'Async, fleet and online tuning')")
        if executor != "sync":
            raise ValueError(f"unknown executor {executor!r}; expected "
                             f"'sync'")

        if objective is None:
            def objective(config: Config) -> float:
                return self.run(configs=[config])[0].total_s

            if objective_batch is None:
                def objective_batch(configs: Sequence[Config]
                                    ) -> List[float]:
                    return [r.total_s for r in self.run(configs=configs)]

        session = TuningSession(
            self.spec.engine.name, objective, scenario_key=self.key,
            optimizer=optimizer, budget=budget, seed=seed, n_init=n_init,
            random_prob=random_prob, batch_size=batch_size,
            objective_batch=objective_batch if batch_size > 1 else None)
        return session.run(verbose=verbose)

    def sweep(self, *args, **kwargs):
        raise NotImplementedError(
            "Study.sweep is not ported yet (ROADMAP queue 1, item "
            "'Async, fleet and online tuning' lists the remaining Study "
            "surface)")
