"""Study: the typed front-end of the PyTorch port over simulate, tune and
sweep.

* ``Study(spec).run()`` — simulate the spec's engine config (one
  :class:`~repro_torch.core.simulator.SimResult`); ``run(configs=[...])``
  pushes a candidate batch through one shared trace on the spec's device;
* ``Study(spec).tune(budget, batch_size)`` — SMAC-BO knob tuning
  (:class:`~repro_torch.core.bo.tuner.TuningSession`), one batched
  simulator pass per round when ``batch_size > 1``; on a CUDA device the
  model phase scores its candidate pool on the card too;
* ``Study(spec).tune(executor="async", slots=N, scheduler="asha",
  journal=..., resume=...)`` — the asynchronous tune service
  (:mod:`repro_torch.core.tune_service`);
* ``Study(spec).tune(executor="fleet", workers=N, pool=...)`` — the same
  service on a fault-tolerant fleet of worker processes
  (:mod:`repro_torch.core.tune_service.coordinator`);
* ``Study(spec).tune(online=True, window_epochs=W)`` — online re-tuning
  under drift (:mod:`repro_torch.core.tune_online`);
* ``Study(spec).sweep(...)`` — multi-engine × multi-workload grids, each
  (engine, workload) cell one batched simulator pass.

Workload traces are built once per Study and workload spec and shared
across evaluations (builds are deterministic in the spec).

``SimOptions.backend`` picks the epoch loop every call pattern runs:
``"torch"`` (default, the compiled loop on ``SimOptions.device``) or
``"numpy"`` (the reference's loop, bitwise its results, sharded over
``SimOptions.workers`` spawned processes).

Migration table (old call -> new call; the old calls remain as deprecated
shims, on the numpy backend):

=================================================  ==================================================
old                                                new
=================================================  ==================================================
``evaluate(eng, cfg, wl, inp, machine, ...)``      ``Study(ExperimentSpec(engine=EngineSpec(eng, cfg),
                                                   workload=WorkloadSpec(wl, inp), ...)).run().total_s``
``evaluate_batch(eng, cfgs, wl, ...)``             ``Study(spec).run(configs=cfgs)``
``run_simulation(workload, eng, cfg, machine)``    ``Study(spec).run()`` (full ``SimResult``)
``tune_scenario(eng, Scenario(...), budget)``      ``Study(spec).tune(budget=..., batch_size=...)``
``Scenario(workload, inp, machine, ...)``          ``ExperimentSpec`` (+ ``SimOptions`` for seeds/
                                                   sampler/workers/backend)
``make_engine(name, cfg, tier)``                   ``@register_engine(name)`` + ``Study``
``grid_search(space, objective, knob_values)``     ``Study(spec).run(configs=<grid configs>)``
=================================================  ==================================================
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

from ..spans import span
from .bo.tuner import TuningResult, TuningSession
from .tune_service.faults import FaultPlan
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

    def __init__(self, spec: ExperimentSpec, *,
                 machine: Optional[Machine] = None):
        if not isinstance(spec, ExperimentSpec):
            raise TypeError(f"expected ExperimentSpec, got {type(spec)!r}")
        if machine is not None and machine.name != spec.machine:
            raise ValueError(f"machine override {machine.name!r} does not "
                             f"match spec.machine {spec.machine!r}")
        self.spec = spec
        # an explicit Machine instance overrides the registry resolution
        # (how the legacy shims honour ad-hoc Machine objects)
        self.machine: Machine = machine if machine is not None \
            else get_machine(spec.machine)
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
            with span("repro_torch.workload.build"):
                wl = make_workload(wspec.name, wspec.input_name,
                                   threads=threads, scale=wspec.scale,
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
        with span("repro_torch.study.run"):
            results = run_simulation_batch(
                self.workload(), self.spec.engine.name, batch, self.machine,
                fast_slow_ratio=self.spec.fast_slow_ratio, seeds=opts.seed,
                sampler=opts.sampler, record_heatmap=opts.record_heatmap,
                heat_bins=opts.heat_bins,
                fast_capacity_pages=self.spec.fast_capacity_pages,
                crn=opts.crn, device=opts.device, backend=opts.backend,
                workers=opts.workers, exact_select=opts.exact_select)
        return results[0] if configs is None else results

    def tune(self, budget: int = 100, batch_size: int = 1, seed: int = 0,
             optimizer: str = "smac", n_init: int = 20,
             random_prob: float = 0.20, verbose: bool = False,
             space: Optional[KnobSpace] = None,
             surrogate: Optional[str] = None,
             acquisition: Optional[str] = None,
             objective: Optional[Callable[[Config], float]] = None,
             objective_batch: Optional[
                 Callable[[Sequence[Config]], Sequence[float]]] = None,
             executor: str = "sync", slots: int = 1,
             scheduler: Optional[str] = None,
             journal: Optional[str] = None, resume: bool = False,
             pool: str = "thread", eta: int = 4,
             window: Optional[int] = None,
             workers: Optional[int] = None, retries: int = 1,
             timeout_s: Optional[float] = None,
             faults: Optional[FaultPlan] = None,
             heartbeat_s: Optional[float] = None,
             lease_deadline: Optional[int] = None,
             max_respawns: Optional[int] = None,
             fleet_spec: Optional[Any] = None,
             online: bool = False,
             window_epochs: Optional[int] = None,
             hysteresis: float = 0.05,
             dwell_windows: int = 2) -> TuningResult:
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
        ``surrogate`` picks the forest grower (``"fast"``, the default, or
        the recursive ``"reference"`` grower; both grow bitwise the same
        forest) and ``acquisition`` the scoring pipeline (``"fused"``, the
        default, or ``"legacy"``: per-config dict pools, a per-tree
        descent and a scalar-erf EI on the host, the reference's older
        pipeline, with its own history).

        ``objective`` (``config -> float``, lower is better) replaces the
        simulator with a custom objective — e.g. the serving score of a
        ``TieredKVCache`` traffic replay
        (:func:`repro_torch.serving_replay.serving_objective`) — while the
        spec still names what is tuned (the engine resolves the knob
        space).  ``objective_batch`` (``[config] -> [float]``) is its
        vectorized counterpart for ``batch_size > 1``; without it the
        scalar objective is mapped over each round.

        **Async tuning and resume** (``executor="async"``): the study is
        handed to :class:`~repro_torch.core.tune_service.TuneService`.
        ``slots`` evaluation slots stay saturated with trials (a new trial
        is asked the moment the ask-ahead ``window``, default ``slots``,
        has room); results are committed in canonical creation order and
        every decision (ask, rung, tell) happens at commit time, so the
        study is a deterministic function of its parameters however the
        completions interleave.  At ``slots=1, scheduler=None`` it
        reproduces the synchronous path bit-identically.

        * ``pool`` -- ``"thread"`` (default: every slot shares this
          process's card) or ``"process"`` (spawned workers, each
          starting CUDA and loading the kernels itself);
        * ``scheduler="asha"`` -- successive-halving early stopping over
          1/4, 1/2 and full-epoch rungs (``eta`` the promotion fraction);
          stopped trials are told their value extrapolated to full
          budget, promoted ones resume from their rung's host carry.  Not
          with a custom ``objective=``;
        * ``journal=<path>`` -- the JSON-lines study journal (every
          ask/eval/rung/tell/fail; ``tools/journal_schema.py`` validates
          it).  ``resume=True`` re-runs the control loop with the journal
          as an evaluation cache: a killed study's resumed journal is
          byte-identical to an uninterrupted run's;
        * ``retries`` -- per-trial retries of a failed segment before the
          trial is journaled FAILED; ``timeout_s`` -- per-unit bound that
          turns a hung evaluation into such a failure.

        It returns an
        :class:`~repro_torch.core.tune_service.AsyncTuningResult` (the
        trial table, slot utilization and ASHA savings beside the
        history).

        **Fault-tolerant fleet tuning** (``executor="fleet",
        workers=N``): the same deterministic control loop, its slots N
        worker processes behind a lease-and-commit coordinator
        (:class:`~repro_torch.core.tune_service.FleetExecutor`).  Workers
        always start by spawn.  Each starts CUDA on its device and loads
        ``select_topk`` before it greets, and units are leased to greeted
        workers only: the workers this process spawns take
        ``spec.options.device``, a worker of a ``fleet_spec`` its own
        ``--device``, and a worker answers a unit for another device than
        its own with an error result.  A worker
        heartbeats its unit every ``heartbeat_s``; a lease silent for
        ``lease_deadline`` heartbeats, a dead worker or a lost result
        expires it and the unit is re-issued (at most four attempts).
        Duplicate execution is safe because a unit is a pure function of
        its coordinates: the first result commits and a late twin is
        asserted bitwise equal.  Lease events (``lease``/``expire``/
        ``reissue``/``reject``/``reconnect``) are journaled at the unit's
        commit, so fault twins and a SIGKILLed coordinator's resume are
        byte-identical.  The result's ``fleet`` receipt holds the
        re-issue, death, respawn and reject counts and the workers'
        ``kernel_launches``.

        * ``workers`` -- fleet size (default ``slots``); ``pool``
          ``"process"`` (spawned on this host, one hot spare) or
          ``"socket"`` (workers dial in over TCP: ``python -m
          repro_torch.core.tune_service.worker --connect HOST:PORT``);
        * ``fleet_spec`` -- a frozen
          :class:`~repro_torch.core.tune_service.FleetSpec` (implies
          ``pool="socket"``): the bind address, the shared ``auth_key``
          every frame is HMAC-signed with, the worker count and hosts,
          heartbeat, lease and frame caps; ``python -m
          repro_torch.launch.fleet`` mints one (``--init``) and starts or
          prints its workers.  The key never enters the journal;
        * ``scheduler="asha"`` composes with the fleet: a rung unit
          re-derives ``[0, hi)`` from scratch (no carry crosses the
          transport), so the trials equal the local slots' bitwise;
        * ``heartbeat_s`` / ``lease_deadline`` / ``max_respawns`` --
          heartbeat cadence, the lease deadline in missed heartbeats, and
          the respawn budget for dead process workers; at zero live
          workers the coordinator runs units on a local slot (slower,
          never wedged);
        * ``faults`` -- a :class:`~repro_torch.core.tune_service.FaultPlan`
          of injected worker and network faults keyed by unit and
          attempt (:mod:`repro_torch.core.tune_service.faults`).

        A script that uses ``pool="process"`` (either executor) needs the
        ``if __name__ == "__main__":`` guard: spawned workers import the
        main module again.

        **Online re-tuning under drift** (``online=True,
        window_epochs=W``): the study becomes the sliding-window control
        loop of :mod:`repro_torch.core.tune_online`.  Every ``W`` epochs
        ONE CRN segment evaluates ``[deployed] + batch_size`` candidates
        from the deployed system's carry; a detected phase change
        warm-restarts the optimizer from the prior elites; a switch is
        applied only past the ``hysteresis`` margin and ``dwell_windows``
        windows after the last one.  ``budget`` caps the candidate
        evaluations.  Requires ``SimOptions(backend="torch",
        crn=True)``; ``journal=`` and ``resume=`` give the async path's
        byte-identical kill/resume contract.  Returns an
        :class:`~repro_torch.core.tune_online.OnlineTuningResult`.
        """
        if online:
            from .tune_online import OnlineTuner
            if executor != "sync":
                raise ValueError(
                    "online=True runs its own window loop; it is "
                    "incompatible with executor='async'/'fleet'")
            if window_epochs is None:
                raise ValueError(
                    "online=True requires window_epochs=W (the re-tuning "
                    "window length in epochs)")
            if scheduler is not None or objective is not None \
                    or objective_batch is not None:
                raise ValueError(
                    "online=True is incompatible with scheduler=/"
                    "objective=: the window loop needs the simulator's "
                    "segment checkpoints")
            tuner = OnlineTuner(
                self, window_epochs=window_epochs, batch_size=batch_size,
                budget=budget, seed=seed, n_init=n_init,
                hysteresis=hysteresis, dwell_windows=dwell_windows,
                space=space, journal=journal, resume=resume,
                verbose=verbose)
            return tuner.run()
        if window_epochs is not None:
            raise ValueError("window_epochs requires online=True")
        if executor in ("async", "fleet"):
            from .tune_service import TuneService
            if batch_size != 1 or objective_batch is not None:
                raise ValueError(
                    "executor='async' replaces per-round batching with "
                    "slot saturation; use slots=N instead of batch_size")
            service = TuneService(
                self, budget=budget, slots=slots, scheduler=scheduler,
                seed=seed, optimizer=optimizer, n_init=n_init,
                random_prob=random_prob, space=space, surrogate=surrogate,
                acquisition=acquisition, objective=objective,
                journal=journal, resume=resume, pool=pool, eta=eta,
                window=window, verbose=verbose,
                executor="fleet" if executor == "fleet" else "local",
                workers=workers, retries=retries, timeout_s=timeout_s,
                faults=faults, heartbeat_s=heartbeat_s,
                lease_deadline=lease_deadline, max_respawns=max_respawns,
                fleet_spec=fleet_spec)
            return service.run()
        if executor != "sync":
            raise ValueError(f"unknown executor {executor!r}; expected "
                             f"'sync', 'async' or 'fleet'")
        if scheduler is not None or slots != 1 or journal is not None \
                or resume or window is not None or workers is not None \
                or timeout_s is not None or faults is not None \
                or heartbeat_s is not None or lease_deadline is not None \
                or max_respawns is not None or fleet_spec is not None:
            raise ValueError(
                "slots/scheduler/journal/resume/window/workers/timeout_s/"
                "faults/heartbeat_s/lease_deadline/max_respawns/fleet_spec "
                "require executor='async' or 'fleet'")

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
            crn=self.spec.options.crn, surrogate=surrogate,
            acquisition=acquisition, device=self.spec.options.device)
        return session.run(verbose=verbose)

    def sweep(self, grid: Optional[Mapping[str, Sequence[Any]]] = None, *,
              engines: Optional[Sequence[Union[EngineSpec, str]]] = None,
              workloads: Optional[Sequence[Union[WorkloadSpec, str]]] = None,
              configs: Optional[Sequence[Mapping[str, Any]]] = None,
              ) -> SweepResult:
        """Evaluate a multi-engine × multi-workload grid, one batched pass
        per (engine, workload) cell: on the spec's device, in order, or on
        the numpy backend through one shard queue over ``workers``
        processes.

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
            crn=opts.crn, device=opts.device, backend=opts.backend,
            workers=opts.workers, exact_select=opts.exact_select)
        return SweepResult(cells=dict(zip(cell_keys, results)))
