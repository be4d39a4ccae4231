"""Component registries of the PyTorch port: the extension seam of the
typed experiment API.

Engines, workloads, samplers, simulation backends and machine profiles
register themselves here by name; every dispatch site resolves through a
:class:`Registry`, and unknown names raise ``KeyError`` with a
did-you-mean suggestion.  Registering a new component never requires
touching core dispatch code:

    from repro_torch.core.registry import register_engine

    @register_engine("my-policy", space=MY_KNOB_SPACE)
    class BatchMyPolicyEngine(BatchTieringEngine):
        ...

    Study(ExperimentSpec(engine="my-policy", workload="gups")).run()

The tables (the reference package's, plus one):

* ``ENGINES`` -- numpy batch engines
  (:class:`~repro_torch.core.engine.BatchTieringEngine` subclasses), the
  ``backend="numpy"`` implementation of each policy;
* ``COMPILED`` -- compiled engine definitions
  (:class:`~repro_torch.core.engine_torch.EngineDef` subclasses), the
  ``backend="torch"`` epoch loop's implementation.  ``register_engine``
  files a class in the table its type names, so a policy may have either
  implementation or both; under ``backend="torch"`` one without a compiled
  definition runs the numpy epoch loop (with one warning);
* ``WORKLOADS`` -- numpy trace factories;
* ``SAMPLERS`` -- numpy monitoring samplers ``draw(rng, base, period)``
  (the compiled loop's fused draw serves ``"elementwise"`` and
  ``"sparse"``);
* ``BACKENDS`` -- zero-argument factories of the numpy loop's vectorized
  access-cost callable (``"numpy"``: float64 on the host; ``"torch"``:
  the compiled loop's cost model, float32 on ``SimOptions.device``);
* ``MACHINES`` -- :class:`~repro_torch.core.simulator.Machine` profiles.

Builtin components register when their defining module is imported
(``engine``, ``engine_torch``, ``workloads``, ``simulator``); importing
``repro_torch.core.specs`` pulls all of them in.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import (Any, Callable, Dict, Generic, Iterator, List, Optional,
                    Tuple, TypeVar)

T = TypeVar("T")


def _unknown_message(kind: str, name: Any, known) -> str:
    close = difflib.get_close_matches(str(name), list(known), n=1,
                                      cutoff=0.5)
    hint = f"; did you mean {close[0]!r}?" if close else ""
    have = ", ".join(sorted(known)) or "<none>"
    return f"unknown {kind} {name!r}{hint} (registered: {have})"


class Registry(Generic[T]):
    """A named component table with decorator registration and fuzzy errors."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str, obj: Optional[T] = None, *,
                 overwrite: bool = False):
        """Register ``obj`` under ``name``; usable as a decorator
        (``@registry.register("foo")``).  Duplicate names raise unless
        ``overwrite=True``."""
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

    def unregister(self, name: str) -> None:
        """Remove ``name`` (KeyError with suggestions if absent); mainly for
        tests that register throwaway components."""
        if name not in self._entries:
            raise KeyError(self.unknown_message(name))
        del self._entries[name]

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
        return _unknown_message(self.kind, name, self._entries)

    # -- dict-like views ---------------------------------------------------
    def names(self) -> List[str]:
        return sorted(self._entries)

    def items(self) -> List[Tuple[str, T]]:
        return sorted(self._entries.items())

    def values(self) -> List[T]:
        return [v for _, v in self.items()]

    def keys(self) -> List[str]:
        return self.names()

    def __getitem__(self, name: str) -> T:
        return self.get(name)

    def __setitem__(self, name: str, obj: T) -> None:
        """Dict-style assignment is ``register(..., overwrite=True)``."""
        self.register(name, obj, overwrite=True)

    def __contains__(self, name: object) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self.names())

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, {self.names()})"


ENGINES: Registry[type] = Registry("engine")
COMPILED: Registry[type] = Registry("compiled engine")
WORKLOADS: "Registry[WorkloadFactory]" = Registry("workload")
SAMPLERS: Registry[Callable[..., Any]] = Registry("sampler")
BACKENDS: Registry[Callable[[], Callable[..., Any]]] = Registry("backend")
MACHINES: Registry[Any] = Registry("machine")


def check_engine(name: str) -> None:
    """Raise ``KeyError`` (with a did-you-mean hint over every engine
    name) unless ``name`` has a numpy engine or a compiled definition."""
    if name not in ENGINES and name not in COMPILED:
        raise KeyError(_unknown_message(
            "engine", name, set(ENGINES.names()) | set(COMPILED.names())))


def register_engine(name: str, *, space: Any = None, overwrite: bool = False):
    """Class decorator registering a tiering engine under ``name``.

    An :class:`~repro_torch.core.engine_torch.EngineDef` subclass becomes
    the name's compiled definition (``COMPILED``); any other class -- a
    :class:`~repro_torch.core.engine.BatchTieringEngine` subclass -- its
    numpy engine (``ENGINES``).  ``space`` optionally registers the
    engine's knob space so ``get_space(name)`` / ``Study.tune()`` work.
    """
    def deco(cls: type) -> type:
        from .engine_torch import EngineDef
        table = COMPILED if isinstance(cls, type) and \
            issubclass(cls, EngineDef) else ENGINES
        table.register(name, cls, overwrite=overwrite)
        if space is not None:
            from .knobs import SPACES
            SPACES[name] = space
        return cls
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


def register_sampler(name: str, fn: Optional[Callable[..., Any]] = None, *,
                     overwrite: bool = False):
    """Register a numpy monitoring sampler ``draw(rng, base, period) ->
    counts``; usable as a decorator."""
    return SAMPLERS.register(name, fn, overwrite=overwrite)


def register_backend(name: str, factory: Optional[Callable[[], Any]] = None,
                     *, overwrite: bool = False):
    """Register an access-cost backend: a zero-argument factory returning
    the vectorized cost callable of the numpy epoch loop."""
    return BACKENDS.register(name, factory, overwrite=overwrite)


def register_machine(machine: Any, *, overwrite: bool = False):
    """Register a :class:`~repro_torch.core.simulator.Machine` by name."""
    MACHINES.register(machine.name, machine, overwrite=overwrite)
    return machine
