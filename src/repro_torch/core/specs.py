"""Typed experiment specs of the PyTorch port (JSON round-trippable).

The same contract as the reference package's specs, adapted to the port's
single backend:

* :class:`EngineSpec` — engine name (registry-validated) + knob config
  (validated/completed against the engine's knob space);
* :class:`WorkloadSpec` — workload name + input, thread count and scale;
* :class:`SimOptions` — *how* to evaluate: seed, sampler, common random
  numbers, the torch device, heatmap recording;
* :class:`ExperimentSpec` — the composition, plus machine name and
  fast:slow ratio.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Union

import torch

# importing these modules registers the builtin engines, workloads,
# samplers and machines the validators below resolve against
from . import engine_torch as _engine_mod  # noqa: F401
from . import simulator as _sim_mod        # noqa: F401
from . import traffic as _traffic_mod      # noqa: F401  (kv-* workloads)
from . import workloads as _workloads_mod  # noqa: F401
from .knobs import SPACES
from .registry import ENGINES, MACHINES, SAMPLERS, WORKLOADS


def _freeze(obj, field: str, value) -> None:
    object.__setattr__(obj, field, value)


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """A tiering engine plus a fully validated knob configuration
    (``config=None`` resolves to the engine's default config)."""

    name: str
    config: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        ENGINES.get(self.name)
        space = SPACES.get(self.name)
        if space is None:
            cfg = dict(self.config or {})
        elif self.config is None:
            cfg = space.default_config()
        else:
            cfg = space.validate(self.config)
        _freeze(self, "config", cfg)

    def __hash__(self):
        return hash((self.name, tuple(sorted(self.config.items()))))

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "config": dict(self.config)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "EngineSpec":
        return cls(name=d["name"], config=d.get("config"))

    @classmethod
    def coerce(cls, value: "EngineSpec | str | Mapping[str, Any]") -> "EngineSpec":
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls(value)
        return cls.from_dict(value)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """A workload build request: name × input × threads × simulation scale
    (``threads=None`` defers to the machine profile's default)."""

    name: str
    input_name: str = ""
    threads: Optional[int] = None
    scale: float = 0.25

    def __post_init__(self):
        WORKLOADS.get(self.name)
        if not (0.0 < self.scale <= 1.0):
            raise ValueError(f"scale must be in (0, 1], got {self.scale}")

    @property
    def key(self) -> str:
        inp = f":{self.input_name}" if self.input_name else ""
        return f"{self.name}{inp}"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "WorkloadSpec":
        return cls(**dict(d))

    @classmethod
    def coerce(cls, value: "WorkloadSpec | str | Mapping[str, Any]") -> "WorkloadSpec":
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls(value)
        return cls.from_dict(value)


@dataclasses.dataclass(frozen=True)
class SimOptions:
    """How to evaluate.

    ``device`` is the torch device the epoch loop runs on (``"cuda"`` by
    default; tests pass ``"cpu"``).  Asking for CUDA where there is none
    raises when the simulation starts — it never falls back to the CPU.
    ``crn=True`` (common random numbers) gives every config of a batch
    bitwise-identical monitoring noise, so within-batch comparisons are
    paired; the port's counter-based draws support it on every device.
    """

    seed: int = 0
    sampler: str = "elementwise"
    crn: bool = False
    device: str = "cuda"
    record_heatmap: bool = False
    heat_bins: int = 128

    def __post_init__(self):
        SAMPLERS.get(self.sampler)
        torch.device(self.device)  # raises on a malformed device string

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SimOptions":
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One fully-specified experiment: engine × workload × machine × options."""

    engine: Union[EngineSpec, str]
    workload: Union[WorkloadSpec, str]
    machine: str = "pmem-large"
    fast_slow_ratio: float = 8.0
    fast_capacity_pages: Optional[int] = None
    options: SimOptions = dataclasses.field(default_factory=SimOptions)

    def __post_init__(self):
        _freeze(self, "engine", EngineSpec.coerce(self.engine))
        _freeze(self, "workload", WorkloadSpec.coerce(self.workload))
        MACHINES.get(self.machine)
        if isinstance(self.options, Mapping):
            _freeze(self, "options", SimOptions.from_dict(self.options))

    @property
    def key(self) -> str:
        return f"{self.engine.name}/{self.workload.key}@{self.machine}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "engine": self.engine.to_dict(),
            "workload": self.workload.to_dict(),
            "machine": self.machine,
            "fast_slow_ratio": self.fast_slow_ratio,
            "fast_capacity_pages": self.fast_capacity_pages,
            "options": self.options.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentSpec":
        return cls(
            engine=EngineSpec.from_dict(d["engine"]),
            workload=WorkloadSpec.from_dict(d["workload"]),
            machine=d.get("machine", "pmem-large"),
            fast_slow_ratio=d.get("fast_slow_ratio", 8.0),
            fast_capacity_pages=d.get("fast_capacity_pages"),
            options=SimOptions.from_dict(d.get("options", {})),
        )
