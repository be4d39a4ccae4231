"""Typed experiment specs of the PyTorch port (JSON round-trippable).

The same contract as the reference package's specs:

* :class:`EngineSpec` — engine name (registry-validated) + knob config
  (validated/completed against the engine's knob space);
* :class:`WorkloadSpec` — workload name + input, thread count and scale;
* :class:`SimOptions` — *how* to evaluate: seed, sampler, backend,
  workers, common random numbers, selection, the torch device, heatmap
  recording;
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
from .registry import BACKENDS, MACHINES, SAMPLERS, WORKLOADS, check_engine


def _freeze(obj, field: str, value) -> None:
    object.__setattr__(obj, field, value)


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """A tiering engine plus a fully validated knob configuration
    (``config=None`` resolves to the engine's default config)."""

    name: str
    config: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        check_engine(self.name)  # raises with did-you-mean on unknown names
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
    (``threads=None`` defers to the machine profile's default).

    ``scale`` is the share of the paper's deployment (1.0: its RSS and
    rates).  Unlike the reference's spec, which stops at 1.0, it may exceed
    1 -- a deployment larger than the paper's, such as gapbs-bc on kron at
    1.7 (68,004 pages) -- up to the epoch loop's page ceiling
    (``engine_torch.MAX_PAGES``), which the run checks."""

    name: str
    input_name: str = ""
    threads: Optional[int] = None
    scale: float = 0.25

    def __post_init__(self):
        WORKLOADS.get(self.name)
        if not self.scale > 0.0:
            raise ValueError(f"scale must be positive, got {self.scale}")

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
        # a DriftSpec (phase-shifting trace) coerces by registering its
        # composed workload; lazy import: drift.py imports this module
        from .drift import DriftSpec
        if isinstance(value, DriftSpec):
            return cls(value.register())
        return cls.from_dict(value)


@dataclasses.dataclass(frozen=True)
class SimOptions:
    """How to evaluate.

    ``backend`` picks the epoch loop: ``"torch"`` (default) is the compiled
    loop on ``device`` (``"cuda"`` by default; tests pass ``"cpu"``);
    asking for CUDA where there is none raises when the simulation starts
    -- it never falls back to the CPU.  ``"numpy"`` is the reference's
    bit-exact numpy loop on the host, which ``workers`` (an int or
    ``"auto"``: the CPU count) shards over spawned processes; sharding
    never changes results.  An engine with no compiled definition runs
    the numpy loop under ``backend="torch"`` too (one warning), with the
    torch cost model on ``device``.

    ``crn=True`` (common random numbers) gives every config of a batch
    bitwise-identical monitoring noise, so within-batch comparisons are
    paired; it needs the compiled loop's counter-based draws, so it
    raises with ``backend="numpy"``.  ``exact_select=True`` (default)
    plans migrations with the exact ``select_topk`` kernel; ``False`` is
    the reference's 8-bit log-quantized selection ablation (exact counts,
    near-exact order; no kernel).  The numpy loop is always exact.

    :meth:`from_dict` reads the reference's dictionaries too: their
    ``backend="jax"`` (the reference's compiled loop) is ``"torch"``.
    """

    seed: int = 0
    sampler: str = "elementwise"
    workers: Union[int, str] = 1
    backend: str = "torch"
    crn: bool = False
    exact_select: bool = True
    device: str = "cuda"
    record_heatmap: bool = False
    heat_bins: int = 128

    def __post_init__(self):
        SAMPLERS.get(self.sampler)
        BACKENDS.get(self.backend)
        if self.workers not in ("auto", None) and int(self.workers) < 0:
            raise ValueError(f"workers must be >= 0, got {self.workers!r}")
        if self.crn and self.backend != "torch":
            raise ValueError(
                "crn=True (common random numbers) requires backend='torch'; "
                "the numpy engines consume sequential RNG streams that "
                "cannot be shared across a batch")
        torch.device(self.device)  # raises on a malformed device string

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SimOptions":
        d = dict(d)
        if d.get("backend") == "jax":
            d["backend"] = "torch"
        return cls(**d)


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
