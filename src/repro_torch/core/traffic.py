"""Request-arrival traffic for tiered-KV serving (a copy of the reference
package's ``core/traffic.py``).

A :class:`TrafficSpec` is a frozen, JSON-round-trippable description of an
arrival process; :func:`arrival_trace` expands it deterministically (spec +
seed fully determine the trace), and :func:`replay_schedule` turns it into
the per-step active/done masks a ``TieredKVCache`` decode loop replays.

Two arrival patterns ship:

* ``"poisson"`` — stationary Poisson arrivals at ``arrival_rate`` requests
  per decode step (the open-loop serving baseline);
* ``"bursty-diurnal"`` — a sinusoidal load cycle (``period``,
  ``amplitude``) with random multiplicative bursts (``burst_prob``,
  ``burst_factor``), the tail-latency stressor.

The same traffic drives the simulator: ``kv-poisson`` / ``kv-diurnal`` are
registered workloads whose per-epoch access vectors replay the serving
access profile (:func:`step_read_counts`) over the replayed occupancy, so
``Study(ExperimentSpec(engine="kv-hemem", workload="kv-poisson"))`` tunes
the traffic the serving path measures.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .registry import register_workload
from .workloads import PAGE_BYTES, Workload

PATTERNS = ("poisson", "bursty-diurnal")


def step_read_counts(lengths, max_pages: int, page_tokens: int, scale: int,
                     xp=np):
    """Integer per-page access counts for one decode step.

    The serving access pattern (attention sink + recency + uniform base)
    quantized to int32 access counts: for a sequence covering ``n_p``
    pages,

    * every active page gets ``scale // (20 * n_p)``        (~0.05 mass),
    * page 0 additionally ``35 * scale // 100``             (~0.35, sink),
    * the last ``min(n_p, 2)`` pages additionally
      ``45 * scale // (100 * min(n_p, 2))``                 (~0.45, recency).

    ``xp=np`` takes and returns numpy arrays; ``xp=torch`` takes a tensor
    and returns tensors on its device.  Pure int32 arithmetic, so both
    give the same bits.  Returns ``(counts, active_page)``: ``(B,
    max_pages)`` int32 counts and the boolean active-page mask.
    """
    if xp is torch:
        lengths = torch.as_tensor(lengths)
        i32 = torch.int32
        ar = torch.arange(max_pages, dtype=i32, device=lengths.device)[None, :]
        n_p = ((torch.clamp(lengths, min=1).to(i32) - 1)
               // page_tokens + 1)[:, None]                     # (B, 1)
        zero = torch.zeros((), dtype=i32, device=lengths.device)
        scale_t = torch.full((), scale, dtype=i32, device=lengths.device)
        c = scale_t // (20 * n_p)
        c = c + torch.where(ar == 0, 35 * scale // 100, zero)
        rec = (45 * scale_t) // (100 * torch.clamp(n_p, max=2))
        c = c + torch.where(ar >= n_p - 2, rec, zero)
        active = ar < n_p
        return torch.where(active, c, zero), active
    lengths = np.asarray(lengths)
    ar = np.arange(max_pages, dtype=np.int32)[None, :]
    n_p = ((np.maximum(lengths, 1).astype(np.int32) - 1)
           // np.int32(page_tokens) + 1)[:, None]           # (B, 1)
    active = ar < n_p
    c = np.int32(scale) // (np.int32(20) * n_p)
    c = c + np.where(ar == 0, np.int32(35 * scale // 100), np.int32(0))
    rec = np.int32(45 * scale) // (np.int32(100) * np.minimum(n_p, 2))
    c = c + np.where(ar >= n_p - 2, rec, np.int32(0))
    return np.where(active, c, np.int32(0)), active


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Replayable arrival process for one serving run."""

    pattern: str = "poisson"
    arrival_rate: float = 4.0      # mean new requests per decode step
    steps: int = 512
    decode_lo: int = 32            # per-request decode length (tokens),
    decode_hi: int = 96            # uniform in [lo, hi]
    period: int = 128              # diurnal cycle length (steps)
    amplitude: float = 0.8         # diurnal modulation depth (0..1)
    burst_prob: float = 0.02       # per-step burst probability
    burst_factor: float = 6.0      # burst rate multiplier

    def __post_init__(self):
        # validated at construction: a bad spec would otherwise survive as
        # an all-zero trace that looks like a measurement
        if self.pattern not in PATTERNS:
            raise ValueError(f"unknown traffic pattern {self.pattern!r}; "
                             f"expected one of {PATTERNS}")
        if self.arrival_rate < 0:
            raise ValueError(f"arrival_rate must be >= 0, "
                             f"got {self.arrival_rate}")
        if self.steps < 1:
            raise ValueError(f"steps must be >= 1, got {self.steps}")
        if self.decode_lo < 1:
            raise ValueError(f"decode_lo must be >= 1, "
                             f"got {self.decode_lo}")
        if self.decode_lo > self.decode_hi:
            raise ValueError(
                f"decode_lo must be <= decode_hi, got "
                f"decode_lo={self.decode_lo} > decode_hi={self.decode_hi}")
        if self.period < 1:
            raise ValueError(f"period must be >= 1, got {self.period}")
        if not 0.0 <= self.amplitude <= 1.0:
            raise ValueError(
                f"amplitude must be in [0, 1] (modulation depth; >1 would "
                f"drive the diurnal rate negative), got {self.amplitude}")
        if not 0.0 <= self.burst_prob <= 1.0:
            raise ValueError(f"burst_prob must be a probability in [0, 1], "
                             f"got {self.burst_prob}")
        if self.burst_factor < 0:
            raise ValueError(f"burst_factor must be >= 0, "
                             f"got {self.burst_factor}")

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "TrafficSpec":
        known = [f.name for f in dataclasses.fields(TrafficSpec)]
        unknown = sorted(set(d) - set(known))
        if unknown:
            hints = []
            for k in unknown:
                close = difflib.get_close_matches(k, known, n=1, cutoff=0.5)
                hints.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)"
                                         if close else ""))
            raise KeyError(f"unknown TrafficSpec keys: {', '.join(hints)} "
                           f"(known: {', '.join(known)})")
        return TrafficSpec(**d)


def arrival_trace(spec: TrafficSpec,
                  seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Expand a spec into ``(arrivals, req_lengths)``.

    ``arrivals[t]`` is the number of requests arriving at step ``t``;
    ``req_lengths`` holds each request's decode length in arrival order.
    Deterministic in ``(spec, seed)``.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(spec.steps)
    if spec.pattern == "poisson":
        lam = np.full(spec.steps, spec.arrival_rate)
    else:                                    # bursty-diurnal
        lam = spec.arrival_rate * (
            1.0 + spec.amplitude * np.sin(2.0 * np.pi * t / spec.period))
        burst = rng.random(spec.steps) < spec.burst_prob
        lam = np.where(burst, lam * spec.burst_factor, lam)
    arrivals = rng.poisson(np.maximum(lam, 0.0))
    req_lengths = rng.integers(spec.decode_lo, spec.decode_hi + 1,
                               int(arrivals.sum()))
    return arrivals, req_lengths


def replay_schedule(spec: TrafficSpec, batch: int, max_tokens: int,
                    seed: int) -> Dict[str, np.ndarray]:
    """Replay the arrival process over ``batch`` sequence slots.

    Requests queue FIFO for a free slot, decode one token per step, and
    complete when their decode length (clamped to ``max_tokens``) is
    reached.  Returns per-step boolean masks ``active`` (decode this step)
    and ``done`` (completed AFTER this step; the caller resets those
    sequences), plus ``completed``/``queued_peak`` scalars.
    """
    arrivals, req_lengths = arrival_trace(spec, seed)
    req_lengths = np.minimum(req_lengths, max_tokens)
    active = np.zeros((spec.steps, batch), bool)
    done = np.zeros((spec.steps, batch), bool)
    target = np.zeros(batch, np.int64)       # remaining tokens per slot
    queue: list = []
    nxt = 0
    completed = 0
    queued_peak = 0
    for t in range(spec.steps):
        queue.extend(req_lengths[nxt:nxt + arrivals[t]])
        nxt += arrivals[t]
        for b in range(batch):               # admit into free slots, FIFO
            if target[b] == 0 and queue:
                target[b] = queue.pop(0)
        queued_peak = max(queued_peak, len(queue))
        running = target > 0
        active[t] = running
        target[running] -= 1
        done[t] = running & (target == 0)
        completed += int(done[t].sum())
    return {"active": active, "done": done,
            "completed": np.int64(completed),
            "queued_peak": np.int64(queued_peak)}


# ---------------------------------------------------------------------------
# simulator workloads: the serving traffic as epoch access vectors, so the
# kv-hemem engine can be studied/tuned on the simulator stack too
# ---------------------------------------------------------------------------
#: page geometry of the simulated serving pool (a mid-size decode config)
_SIM_BATCH, _SIM_PAGES, _SIM_PT = 8, 32, 64
_SIM_SCALE = _SIM_PT * 8 * 4 * 64            # page_tokens*kv_heads*layers*64
_STEPS_PER_EPOCH = 8


def _kv_workload(name: str, spec: TrafficSpec, input_name: str, threads: int,
                 scale: float, seed: int) -> Workload:
    B = max(2, int(round(_SIM_BATCH * scale)))
    n = B * _SIM_PAGES
    sched = replay_schedule(spec, B, _SIM_PAGES * _SIM_PT, seed)
    active = sched["active"]
    n_epochs = spec.steps // _STEPS_PER_EPOCH
    reads = np.zeros((n_epochs, n), np.float64)
    writes = np.zeros((n_epochs, n), np.float64)
    lengths = np.zeros(B, np.int64)
    for t in range(n_epochs * _STEPS_PER_EPOCH):
        act = active[t]
        lengths[~act] = 0                    # completed slots reset
        lengths[act] += 1
        cnt, _ = step_read_counts(lengths, _SIM_PAGES, _SIM_PT, _SIM_SCALE,
                                  xp=np)
        cnt = np.where(act[:, None], cnt, 0)
        e = t // _STEPS_PER_EPOCH
        reads[e] += cnt.reshape(n)
        tail = np.minimum((np.maximum(lengths, 1) - 1) // _SIM_PT,
                          _SIM_PAGES - 1)
        pid = np.arange(B) * _SIM_PAGES + tail
        writes[e, pid[act]] += 1.0

    def epoch_access(e: int):
        return reads[e % n_epochs], writes[e % n_epochs]

    return Workload(name, input_name, n * PAGE_BYTES / 2 ** 30, n, n_epochs,
                    epoch_ms=100.0, threads=threads, mlp=4.0,
                    compute_ms=10.0, scale=scale, epoch_access=epoch_access,
                    seed=seed)


@register_workload("kv-poisson", default_input="")
def _kv_poisson(input_name: str, threads: int, scale: float,
                seed: int) -> Workload:
    return _kv_workload("kv-poisson", TrafficSpec(pattern="poisson"),
                        input_name, threads, scale, seed)


@register_workload("kv-diurnal", default_input="")
def _kv_diurnal(input_name: str, threads: int, scale: float,
                seed: int) -> Workload:
    return _kv_workload("kv-diurnal", TrafficSpec(pattern="bursty-diurnal"),
                        input_name, threads, scale, seed)
