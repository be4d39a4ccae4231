"""Typed experiment API of the PyTorch port over the tiering simulator,
engines, workloads and the SMAC tuner.

* :class:`~repro_torch.core.study.Study` — ``run()`` / ``tune()`` /
  ``sweep()`` (a :class:`~repro_torch.core.study.SweepResult`)
* :class:`~repro_torch.core.specs.ExperimentSpec` (+ ``EngineSpec``,
  ``WorkloadSpec``, ``SimOptions``) — typed, JSON-round-trippable specs
* :mod:`~repro_torch.core.registry` — engines, workloads, samplers and
  machines by name
* :class:`~repro_torch.core.drift.DriftSpec` — phase-shifting workloads
  (importing the package registers the builtin ``drift-*`` scenarios)
"""

from .drift import DriftPhase, DriftSpec
from .registry import (ENGINES, MACHINES, SAMPLERS, WORKLOADS, Registry,
                       register_engine, register_machine, register_sampler,
                       register_workload)
from .specs import EngineSpec, ExperimentSpec, SimOptions, WorkloadSpec
from .study import Study, SweepResult

__all__ = [
    "DriftPhase", "DriftSpec",
    "ENGINES", "MACHINES", "SAMPLERS", "WORKLOADS", "Registry",
    "register_engine", "register_machine", "register_sampler",
    "register_workload",
    "EngineSpec", "ExperimentSpec", "SimOptions", "WorkloadSpec", "Study",
    "SweepResult",
]
