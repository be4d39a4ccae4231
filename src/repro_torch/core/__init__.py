"""Typed experiment API of the PyTorch port over the tiering simulator,
engines, workloads and the SMAC tuner.

* :class:`~repro_torch.core.study.Study` — ``run()`` / ``tune()``
* :class:`~repro_torch.core.specs.ExperimentSpec` (+ ``EngineSpec``,
  ``WorkloadSpec``, ``SimOptions``) — typed, JSON-round-trippable specs
* :mod:`~repro_torch.core.registry` — engines, workloads, samplers and
  machines by name
"""

from .registry import (ENGINES, MACHINES, SAMPLERS, WORKLOADS, Registry,
                       register_engine, register_machine, register_sampler,
                       register_workload)
from .specs import EngineSpec, ExperimentSpec, SimOptions, WorkloadSpec
from .study import Study

__all__ = [
    "ENGINES", "MACHINES", "SAMPLERS", "WORKLOADS", "Registry",
    "register_engine", "register_machine", "register_sampler",
    "register_workload",
    "EngineSpec", "ExperimentSpec", "SimOptions", "WorkloadSpec", "Study",
]
