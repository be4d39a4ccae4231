"""Study: the typed front-end of the PyTorch port over simulate, tune and
sweep.

* ``Study(spec).run()`` — simulate the spec's engine config (one
  :class:`~repro_torch.core.simulator.SimResult`); ``run(configs=[...])``
  pushes a candidate batch through one shared trace on the spec's device;
* ``Study(spec).tune(budget, batch_size)`` — SMAC-BO knob tuning
  (:class:`~repro_torch.core.bo.tuner.TuningSession`), one batched
  simulator pass per round when ``batch_size > 1``; on a CUDA device the
  model phase scores its candidate pool on the card too;
* ``Study(spec).sweep(...)`` — multi-engine × multi-workload grids, each
  (engine, workload) cell one batched simulator pass.

Workload traces are built once per Study and workload spec and shared
across evaluations (builds are deterministic in the spec).

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
queue item): ``tune(executor="async"|"fleet")`` and ``tune(online=True)``.
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

from .bo.tuner import TuningResult, TuningSession
from .knobs import Config, KnobSpace
from .simulator import (Machine, SimResult, get_machine,
                        run_simulation_batch, run_simulation_cells)
from .specs import EngineSpec, ExperimentSpec, WorkloadSpec
from .workloads import Workload, make_workload


@dataclasses.dataclass
class SweepResult:
    """Results of a multi-engine × multi-workload sweep.

    ``cells`` maps ``(engine_name, workload_label)`` to the list of
    :class:`~repro_torch.core.simulator.SimResult` for that cell's config
    batch (one entry per config, in input order).  The workload label is
    ``WorkloadSpec.key``; when a sweep contains several variants of the
    same workload (different threads/scale) the label is extended with
    ``#t<threads>/s<scale>`` so no cell is overwritten.
    """

    cells: Dict[Tuple[str, str], List[SimResult]] = \
        dataclasses.field(default_factory=dict)

    def __getitem__(self, key: Tuple[str, str]) -> List[SimResult]:
        return self.cells[key]

    def __len__(self) -> int:
        return len(self.cells)

    def items(self):
        return self.cells.items()

    def total_s(self) -> Dict[Tuple[str, str], List[float]]:
        """Execution times per cell, one per config."""
        return {k: [r.total_s for r in v] for k, v in self.cells.items()}


class Study:
    """Typed front-end: one spec, three call patterns (run/tune/sweep)."""

    def __init__(self, spec: ExperimentSpec):
        if not isinstance(spec, ExperimentSpec):
            raise TypeError(f"expected ExperimentSpec, got {type(spec)!r}")
        self.spec = spec
        self.machine: Machine = get_machine(spec.machine)
        self._workloads: Dict[Tuple, Workload] = {}

    @property
    def key(self) -> str:
        return self.spec.key

    def workload(self, wspec: Optional[WorkloadSpec] = None) -> Workload:
        """The workload of ``wspec`` (the spec's when None), built once per
        Study (builds are deterministic in the spec)."""
        wspec = wspec if wspec is not None else self.spec.workload
        threads = wspec.threads if wspec.threads is not None \
            else self.machine.default_threads
        cache_key = (wspec.name, wspec.input_name, threads, wspec.scale,
                     self.spec.options.seed)
        wl = self._workloads.get(cache_key)
        if wl is None:
            wl = make_workload(wspec.name, wspec.input_name, threads=threads,
                               scale=wspec.scale,
                               seed=self.spec.options.seed)
            self._workloads[cache_key] = wl
        return wl

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
             space: Optional[KnobSpace] = None,
             objective: Optional[Callable[[Config], float]] = None,
             objective_batch: Optional[
                 Callable[[Sequence[Config]], Sequence[float]]] = None,
             executor: str = "sync", online: bool = False) -> TuningResult:
        """SMAC-BO tuning of the spec's engine knobs (§3.1).

        ``seed`` seeds the optimizer; the simulation seed stays
        ``spec.options.seed``.  ``batch_size=q > 1`` evaluates each round
        as one batched simulator pass; with ``spec.options.crn`` every
        candidate of a round sees the same monitoring noise, so the
        optimizer's within-batch comparisons are paired, and
        ``tell_batch(crn=True)`` debiases any re-evaluated config against
        its recorded value.  ``optimizer="random"`` is the paper's
        unguided baseline.

        ``space`` overrides the engine's knob space.  The model phase
        scores each candidate pool on ``spec.options.device``: on a CUDA
        device one torch function on the card ending in the
        ``select_topk`` kernel, on the CPU numpy
        (``repro_torch.core.bo.forest_fast.BACKEND`` pins one).

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
            space=space, optimizer=optimizer, budget=budget, seed=seed,
            n_init=n_init, random_prob=random_prob, batch_size=batch_size,
            objective_batch=objective_batch if batch_size > 1 else None,
            crn=self.spec.options.crn, device=self.spec.options.device)
        return session.run(verbose=verbose)

    def sweep(self, grid: Optional[Mapping[str, Sequence[Any]]] = None, *,
              engines: Optional[Sequence[Union[EngineSpec, str]]] = None,
              workloads: Optional[Sequence[Union[WorkloadSpec, str]]] = None,
              configs: Optional[Sequence[Mapping[str, Any]]] = None,
              ) -> SweepResult:
        """Evaluate a multi-engine × multi-workload grid, one batched pass
        per (engine, workload) cell on the spec's device, in order.

        ``grid`` may bundle the axes as ``{"engines": [...], "workloads":
        [...], "configs": [...]}``; keyword arguments override.  Axes
        default to the spec's engine/workload; bare workload *names*
        inherit the spec's threads and scale (pass full ``WorkloadSpec``s
        to vary them).  ``configs`` (shared across engines) defaults to
        each engine spec's own config, so ``sweep(engines=[...],
        workloads=[...])`` compares engines at their spec'd settings.
        """
        grid = dict(grid or {})
        engines = engines if engines is not None else grid.get("engines")
        workloads = workloads if workloads is not None \
            else grid.get("workloads")
        configs = configs if configs is not None else grid.get("configs")
        base_ws = self.spec.workload

        def _ws(w):
            if isinstance(w, str):  # same threads/scale, different workload
                return WorkloadSpec(w, threads=base_ws.threads,
                                    scale=base_ws.scale)
            return WorkloadSpec.coerce(w)

        espcs = [EngineSpec.coerce(e) for e in engines] \
            if engines is not None else [self.spec.engine]
        wspcs = [_ws(w) for w in workloads] \
            if workloads is not None else [base_ws]
        opts = self.spec.options
        # disambiguate same-name workload variants (threads/scale sweeps) so
        # cells never overwrite each other
        base_keys = [w.key for w in wspcs]
        labels = [w.key if base_keys.count(w.key) == 1
                  else f"{w.key}#t{w.threads}/s{w.scale}" for w in wspcs]
        if len(set(labels)) != len(labels):
            raise ValueError(f"duplicate workload specs in sweep: {labels}")
        cell_keys = []
        cells = []
        for ws, wlabel in zip(wspcs, labels):
            wl = self.workload(ws)
            for es in espcs:
                batch = [dict(c) for c in configs] if configs is not None \
                    else [es.config]
                cell_keys.append((es.name, wlabel))
                cells.append((wl, es.name, batch))
        results = run_simulation_cells(
            cells, self.machine, fast_slow_ratio=self.spec.fast_slow_ratio,
            seeds=opts.seed, sampler=opts.sampler,
            record_heatmap=opts.record_heatmap, heat_bins=opts.heat_bins,
            fast_capacity_pages=self.spec.fast_capacity_pages,
            crn=opts.crn, device=opts.device)
        return SweepResult(cells=dict(zip(cell_keys, results)))
