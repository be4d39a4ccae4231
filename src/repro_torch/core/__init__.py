"""Typed experiment API of the PyTorch port over the tiering simulator,
engines, workloads and the SMAC tuner.

* :class:`~repro_torch.core.study.Study` — ``run()`` / ``tune()`` /
  ``sweep()`` (a :class:`~repro_torch.core.study.SweepResult`)
* :class:`~repro_torch.core.specs.ExperimentSpec` (+ ``EngineSpec``,
  ``WorkloadSpec``, ``SimOptions``) — typed, JSON-round-trippable specs
* :mod:`~repro_torch.core.registry` — ``@register_engine`` /
  ``@register_workload`` / ``register_sampler`` / ``register_backend`` /
  ``register_machine``: engines (numpy and compiled), workloads,
  samplers, backends and machines by name
* :class:`~repro_torch.core.drift.DriftSpec` — phase-shifting workloads
  (importing the package registers the builtin ``drift-*`` scenarios)

The historical loose-kwargs functions (``evaluate``, ``evaluate_batch``,
``run_simulation``, ``make_engine``, ``tune_scenario``, ``Scenario``,
``grid_search``) remain as deprecated shims on the numpy backend, bitwise
the reference's; see the migration table in the
:mod:`repro_torch.core.study` docstring.
"""

from .drift import DriftPhase, DriftSpec
from .registry import (BACKENDS, COMPILED, ENGINES, MACHINES, SAMPLERS,
                       WORKLOADS, Registry, register_backend, register_engine,
                       register_machine, register_sampler, register_workload)
from .specs import EngineSpec, ExperimentSpec, SimOptions, WorkloadSpec
from .study import Study, SweepResult

__all__ = [
    "DriftPhase", "DriftSpec",
    "BACKENDS", "COMPILED", "ENGINES", "MACHINES", "SAMPLERS", "WORKLOADS",
    "Registry", "register_backend", "register_engine", "register_machine",
    "register_sampler", "register_workload",
    "EngineSpec", "ExperimentSpec", "SimOptions", "WorkloadSpec", "Study",
    "SweepResult",
]
