"""Component registries of the PyTorch port: engines, workloads, samplers
and machine profiles, each resolved by name with did-you-mean errors.

A copy of the reference package's registry, trimmed to what the port runs:

* ``ENGINES`` maps an engine name to its compiled engine definition
  (:class:`~repro_torch.core.engine_torch.EngineDef` subclass);
* ``WORKLOADS`` maps a workload name to its numpy trace factory;
* ``SAMPLERS`` holds the monitoring-sampler *names* the fused Poisson draw
  serves (``"elementwise"`` and ``"sparse"`` are two spellings of one
  distribution; the port has a single draw for both);
* ``MACHINES`` maps a machine name to its :class:`~repro_torch.core.
  simulator.Machine` profile.

There is no backend registry: the port has one backend, the torch epoch
loop.  Builtin components register when their defining module is imported
(``engine_torch``, ``workloads``, ``simulator``); importing
``repro_torch.core.specs`` pulls all of them in.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Any, Callable, Dict, Generic, List, Optional, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """A named component table with decorator registration and fuzzy errors."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str, obj: Optional[T] = None, *,
                 overwrite: bool = False):
        """Register ``obj`` under ``name``; usable as a decorator.
        Duplicate names raise unless ``overwrite=True``."""
        if not isinstance(name, str) or not name:
            raise TypeError(f"{self.kind} name must be a non-empty string, "
                            f"got {name!r}")

        def _add(o: T) -> T:
            if name in self._entries and not overwrite:
                raise ValueError(
                    f"{self.kind} {name!r} is already registered "
                    f"(to {self._entries[name]!r}); pass overwrite=True "
                    f"to replace it")
            self._entries[name] = o
            return o

        return _add if obj is None else _add(obj)

    _MISSING = object()

    def get(self, name: str, default: Any = _MISSING) -> T:
        """Resolve ``name``; a bare ``get(name)`` RAISES ``KeyError`` (with
        a did-you-mean hint) on unknown names."""
        try:
            return self._entries[name]
        except (KeyError, TypeError):
            if default is not Registry._MISSING:
                return default
            raise KeyError(self.unknown_message(name)) from None

    def unknown_message(self, name: Any) -> str:
        close = difflib.get_close_matches(str(name), list(self._entries),
                                          n=1, cutoff=0.5)
        hint = f"; did you mean {close[0]!r}?" if close else ""
        have = ", ".join(sorted(self._entries)) or "<none>"
        return f"unknown {self.kind} {name!r}{hint} (registered: {have})"

    def names(self) -> List[str]:
        return sorted(self._entries)

    def __contains__(self, name: object) -> bool:
        return name in self._entries


ENGINES: Registry[type] = Registry("engine")
WORKLOADS: "Registry[WorkloadFactory]" = Registry("workload")
SAMPLERS: Registry[str] = Registry("sampler")
MACHINES: Registry[Any] = Registry("machine")


def register_engine(name: str, *, space: Any = None, overwrite: bool = False):
    """Class decorator registering a compiled engine definition under
    ``name``; ``space`` optionally registers its knob space."""
    def deco(def_cls: type) -> type:
        ENGINES.register(name, def_cls, overwrite=overwrite)
        if space is not None:
            from .knobs import SPACES
            SPACES[name] = space
        return def_cls
    return deco


@dataclasses.dataclass(frozen=True)
class WorkloadFactory:
    """A registered workload factory plus its default input name."""

    name: str
    make: Callable[..., Any]     # (input_name, threads, scale, seed)
    default_input: str = ""

    def __call__(self, input_name: str, threads: int, scale: float,
                 seed: int):
        return self.make(input_name or self.default_input, threads, scale,
                         seed)


def register_workload(name: str, *, default_input: str = "",
                      overwrite: bool = False):
    """Decorator registering a workload factory ``(input, threads, scale,
    seed) -> Workload`` under ``name``."""
    def deco(make: Callable[..., Any]) -> Callable[..., Any]:
        WORKLOADS.register(name, WorkloadFactory(name, make, default_input),
                           overwrite=overwrite)
        return make
    return deco


def register_sampler(name: str, description: str, *,
                     overwrite: bool = False) -> str:
    """Register a monitoring-sampler name the fused draw serves."""
    return SAMPLERS.register(name, description, overwrite=overwrite)


def register_machine(machine: Any, *, overwrite: bool = False):
    """Register a :class:`~repro_torch.core.simulator.Machine` by name."""
    MACHINES.register(machine.name, machine, overwrite=overwrite)
    return machine
