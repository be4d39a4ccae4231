"""Phase-shifting (drifting) workloads of the PyTorch port: frozen specs
and composed traces (a copy of the reference package's module).

A :class:`DriftSpec` is a frozen, JSON-round-trippable description of a
phase-shifting trace: an ordered tuple of :class:`DriftPhase` entries (each
wrapping a registered :class:`~repro_torch.core.specs.WorkloadSpec` plus a
build ``seed_offset``) and the global ``switch_epochs`` at which each
subsequent phase takes over.  Three drift families ship as constructors:

* :meth:`DriftSpec.splice` -- an A->B splice of any two registered
  workloads (e.g. gups -> silo/ycsb-c): the working set and skew change
  wholesale;
* :meth:`DriftSpec.hotspot` -- the hot set *rotates* over the address
  space: K phases of the same workload built with distinct seed offsets,
  so each phase scatters its hot pages somewhere new;
* :meth:`DriftSpec.wset` -- working-set growth/shrink: phases of the
  ``wset`` workload whose touched fraction grows (or shrinks) per phase.

``spec.register()`` registers the spec as an ordinary workload factory
``(input_name, threads, scale, seed) -> Workload`` (a picklable
:class:`_DriftBuilder`), so a drifting trace threads through everything
that accepts a workload name -- ``Study``, ``run_simulation_batch``,
``run_simulation_segment``, the tune service's process slots -- with no
special-casing: the composed :class:`~repro_torch.core.workloads.Workload`
dispatches ``epoch_access(e)`` to the owning phase, and segments split at
a phase switch equal the whole run bitwise (the epoch loop keys its draws
by absolute epoch).  The tuner half of the story lives in
:mod:`repro_torch.core.tune_online`.

Determinism: the composed trace is a pure function of ``(spec, seed)`` --
phase ``i`` builds its workload with ``seed + phases[i].seed_offset``.

Shape contract: all phases are built at the SAME ``threads``/``scale`` (the
ones the outer ``WorkloadSpec`` requests; per-phase specs contribute name +
input only) and the composed trace uses ``n_pages = max`` over phases,
padding shorter phases' access vectors with zeros, so a drifting run has
one shape throughout.  Machine-interaction scalars (``epoch_ms``, ``mlp``,
``compute_ms``) come from phase 0, so a splice changes the access
*pattern*, not the cost-model constants, keeping per-phase comparisons
paired.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import json
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from .registry import register_workload
from .specs import WorkloadSpec
from .workloads import Workload, make_workload


def _unknown_keys(d: Mapping[str, Any], known: Sequence[str],
                  what: str) -> None:
    """KnobSpace-convention rejection of unknown spec keys, with a
    did-you-mean hint."""
    unknown = sorted(set(d) - set(known))
    if unknown:
        import difflib
        hints = []
        for k in unknown:
            close = difflib.get_close_matches(k, known, n=1, cutoff=0.5)
            hints.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)"
                                     if close else ""))
        raise KeyError(f"unknown {what} keys: {', '.join(hints)} "
                       f"(known: {', '.join(known)})")


@dataclasses.dataclass(frozen=True)
class DriftPhase:
    """One phase of a drifting trace: a workload plus its build-seed offset.

    ``seed_offset`` shifts the phase's build seed (``seed + seed_offset``),
    which is how hotspot rotation gets a fresh scattered hot set per phase
    from one base workload.
    """

    workload: Union[WorkloadSpec, str, Mapping[str, Any]]
    seed_offset: int = 0

    def __post_init__(self):
        object.__setattr__(self, "workload", WorkloadSpec.coerce(self.workload))
        if int(self.seed_offset) != self.seed_offset or self.seed_offset < 0:
            raise ValueError(
                f"seed_offset must be a non-negative int, "
                f"got {self.seed_offset!r}")
        object.__setattr__(self, "seed_offset", int(self.seed_offset))

    def to_dict(self) -> Dict[str, Any]:
        return {"workload": self.workload.to_dict(),
                "seed_offset": self.seed_offset}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DriftPhase":
        _unknown_keys(d, ("workload", "seed_offset"), "DriftPhase")
        return cls(workload=d["workload"],
                   seed_offset=d.get("seed_offset", 0))

    @classmethod
    def coerce(cls, value) -> "DriftPhase":
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            # accept the WorkloadSpec.key shorthand "name:input"
            name, _, inp = value.partition(":")
            return cls(workload=WorkloadSpec(name, inp))
        if isinstance(value, WorkloadSpec):
            return cls(workload=value)
        return cls.from_dict(value)


@dataclasses.dataclass(frozen=True)
class DriftSpec:
    """A frozen phase-shifting trace: phases × switch epochs × total length.

    ``switch_epochs[i]`` is the GLOBAL epoch at which ``phases[i + 1]``
    takes over (strictly increasing, inside ``(0, n_epochs)``); phase 0
    starts at epoch 0 and the final phase runs to ``n_epochs``.  Within a
    phase, the base workload's trace is replayed from its local epoch 0
    (``base epoch = (global - phase_start) % base.n_epochs``).

    Validation happens at construction, matching the ``KnobSpace``
    convention: out-of-range or non-increasing switch epochs, a phase/
    switch count mismatch, and unknown JSON keys (with did-you-mean hints)
    all raise immediately rather than surfacing as silent trace anomalies
    mid-study.
    """

    phases: Tuple[DriftPhase, ...]
    switch_epochs: Tuple[int, ...]
    n_epochs: int
    name: str = ""

    def __post_init__(self):
        phases = tuple(DriftPhase.coerce(p) for p in self.phases)
        object.__setattr__(self, "phases", phases)
        if len(phases) < 2:
            raise ValueError(
                f"a drift needs at least 2 phases, got {len(phases)}; "
                "for a stationary trace use the workload directly")
        switches = tuple(int(s) for s in self.switch_epochs)
        object.__setattr__(self, "switch_epochs", switches)
        if int(self.n_epochs) <= 0:
            raise ValueError(f"n_epochs must be positive, "
                             f"got {self.n_epochs}")
        object.__setattr__(self, "n_epochs", int(self.n_epochs))
        if len(switches) != len(phases) - 1:
            raise ValueError(
                f"need exactly one switch epoch per phase transition "
                f"({len(phases)} phases -> {len(phases) - 1} switches), "
                f"got {len(switches)}")
        prev = 0
        for s in switches:
            if not prev < s < self.n_epochs:
                raise ValueError(
                    f"switch epochs must be strictly increasing inside "
                    f"(0, n_epochs={self.n_epochs}), got {switches}")
            prev = s
        if not self.name:
            object.__setattr__(self, "name", f"drift-{self._digest()}")

    def _digest(self) -> str:
        payload = {"phases": [p.to_dict() for p in self.phases],
                   "switch_epochs": list(self.switch_epochs),
                   "n_epochs": self.n_epochs}
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:10]

    # -- derived views -----------------------------------------------------
    @property
    def phase_starts(self) -> Tuple[int, ...]:
        """Global start epoch of every phase (phase 0 starts at 0)."""
        return (0,) + self.switch_epochs

    def phase_of(self, epoch: int) -> int:
        """Index of the phase that owns ``epoch``."""
        if not 0 <= epoch < self.n_epochs:
            raise ValueError(f"epoch {epoch} outside [0, {self.n_epochs})")
        return bisect.bisect_right(self.phase_starts, epoch) - 1

    # -- constructors ------------------------------------------------------
    @classmethod
    def splice(cls, a, b, switch_epoch: int, n_epochs: int,
               name: str = "") -> "DriftSpec":
        """A→B splice: workload ``a`` runs until ``switch_epoch``, then
        ``b`` takes over until ``n_epochs``."""
        return cls(phases=(DriftPhase.coerce(a), DriftPhase.coerce(b)),
                   switch_epochs=(switch_epoch,), n_epochs=n_epochs,
                   name=name)

    @classmethod
    def hotspot(cls, base: Union[WorkloadSpec, str] = "gups",
                n_phases: int = 3, phase_epochs: int = 20,
                name: str = "") -> "DriftSpec":
        """Hot-set rotation: ``n_phases`` phases of ``base``, each built
        with a distinct seed offset so the scattered hot set lands on a
        fresh page subset every ``phase_epochs`` epochs."""
        if n_phases < 2:
            raise ValueError(f"hotspot drift needs n_phases >= 2, "
                             f"got {n_phases}")
        ws = WorkloadSpec.coerce(base)
        phases = tuple(DriftPhase(ws, seed_offset=i)
                       for i in range(n_phases))
        switches = tuple(phase_epochs * (i + 1) for i in range(n_phases - 1))
        return cls(phases=phases, switch_epochs=switches,
                   n_epochs=phase_epochs * n_phases, name=name)

    @classmethod
    def wset(cls, fractions: Sequence[float] = (0.25, 0.5, 1.0),
             phase_epochs: int = 20, name: str = "") -> "DriftSpec":
        """Working-set growth (or shrink, with decreasing fractions):
        phases of the ``wset`` workload whose touched fraction steps
        through ``fractions``."""
        if len(fractions) < 2:
            raise ValueError("wset drift needs at least 2 fractions")
        phases = tuple(
            DriftPhase(WorkloadSpec("wset", f"f{int(round(f * 100))}"))
            for f in fractions)
        switches = tuple(phase_epochs * (i + 1)
                         for i in range(len(fractions) - 1))
        return cls(phases=phases, switch_epochs=switches,
                   n_epochs=phase_epochs * len(fractions), name=name)

    # -- JSON round trip ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"phases": [p.to_dict() for p in self.phases],
                "switch_epochs": list(self.switch_epochs),
                "n_epochs": self.n_epochs, "name": self.name}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DriftSpec":
        _unknown_keys(d, ("phases", "switch_epochs", "n_epochs", "name"),
                      "DriftSpec")
        return cls(phases=tuple(DriftPhase.coerce(p) for p in d["phases"]),
                   switch_epochs=tuple(d["switch_epochs"]),
                   n_epochs=d["n_epochs"], name=d.get("name", ""))

    # -- registration ------------------------------------------------------
    def register(self, overwrite: bool = True) -> str:
        """Register the composed drifting workload under ``self.name``.

        Returns the registered name, usable anywhere a workload name is
        (``WorkloadSpec(name)``, sweeps, process slots -- the builder is
        picklable, so a spawned process rebuilds the drifting trace from
        the spec exactly).  Registration is idempotent by default
        (``overwrite=True``): the name embeds a content digest, so the
        same spec always maps to the same builder.
        """
        register_workload(self.name, overwrite=overwrite)(
            _DriftBuilder(self))
        return self.name


@dataclasses.dataclass(frozen=True)
class _DriftBuilder:
    """Picklable workload builder compiled from a :class:`DriftSpec`.

    Implements the workload-factory call ``(input_name, threads, scale,
    seed) -> Workload``; module-level and closure-free so spawned
    processes can unpickle it and rebuild the exact trace.
    """

    spec: DriftSpec

    def __call__(self, input_name: str, threads: int, scale: float,
                 seed: int) -> Workload:
        return build_drift_workload(self.spec, input_name=input_name,
                                    threads=threads, scale=scale, seed=seed)


def build_drift_workload(spec: DriftSpec, input_name: str = "",
                         threads: int = 12, scale: float = 0.25,
                         seed: int = 0) -> Workload:
    """Compose the phase workloads into ONE drifting :class:`Workload`.

    All phases are built at the shared ``threads``/``scale`` (phase specs
    contribute name + input only) with build seed ``seed + seed_offset``;
    the composed trace is therefore deterministic in ``(spec, seed)``.
    ``n_pages``/``rss_gib`` take the max over phases and shorter phases'
    access vectors are zero-padded, so the trace shape is constant across
    every phase boundary.
    """
    built = [make_workload(p.workload.name, p.workload.input_name,
                           threads=threads, scale=scale,
                           seed=seed + p.seed_offset)
             for p in spec.phases]
    n = max(w.n_pages for w in built)
    starts = spec.phase_starts

    def epoch_access(e: int):
        i = bisect.bisect_right(starts, e) - 1
        w = built[i]
        reads, writes = w.epoch_access((e - starts[i]) % w.n_epochs)
        if w.n_pages == n:
            return reads, writes
        r = np.zeros(n, dtype=np.float64)
        wr = np.zeros(n, dtype=np.float64)
        r[:w.n_pages] = reads
        wr[:w.n_pages] = writes
        return r, wr

    head = built[0]
    return Workload(spec.name, input_name,
                    rss_gib=max(w.rss_gib for w in built), n_pages=n,
                    n_epochs=spec.n_epochs, epoch_ms=head.epoch_ms,
                    threads=threads, mlp=head.mlp,
                    compute_ms=head.compute_ms, scale=scale,
                    epoch_access=epoch_access, seed=seed)


def window_histogram(workload: Workload, epoch_lo: int,
                     epoch_hi: int) -> np.ndarray:
    """Normalized per-page access histogram over ``[epoch_lo, epoch_hi)``.

    The sampled-histogram phase-change detector's observable: reads +
    writes summed over the window, normalized to unit mass.  Cheap (pure
    numpy over the procedural trace) and deterministic.
    """
    h = np.zeros(workload.n_pages, dtype=np.float64)
    for e in range(epoch_lo, min(epoch_hi, workload.n_epochs)):
        r, w = workload.epoch_access(e)
        h += np.asarray(r, dtype=np.float64)
        h += np.asarray(w, dtype=np.float64)
    s = h.sum()
    return h / s if s > 0 else h


def histogram_divergence(a: np.ndarray, b: np.ndarray) -> float:
    """Total-variation distance between two normalized histograms
    (``0.5 * L1``, in ``[0, 1]``)."""
    return float(0.5 * np.abs(np.asarray(a) - np.asarray(b)).sum())


#: builtin drift scenarios, registered on import (as traffic.py registers
#: kv-poisson/kv-diurnal): a hotspot rotation, a working-set growth ramp
#: and a gups->silo splice, each usable as a plain workload name
BUILTIN_DRIFTS: Dict[str, DriftSpec] = {}
for _spec in (
        DriftSpec.hotspot(base="gups", n_phases=3, phase_epochs=20,
                          name="drift-hotspot"),
        DriftSpec.wset(fractions=(0.25, 0.5, 1.0), phase_epochs=20,
                       name="drift-wset"),
        DriftSpec.splice(WorkloadSpec("gups"),
                         WorkloadSpec("silo", "ycsb-c"),
                         switch_epoch=30, n_epochs=60,
                         name="drift-splice"),
):
    BUILTIN_DRIFTS[_spec.register()] = _spec
del _spec
