"""``observe_launches_per_epoch.sim``: CUDA runtime calls that put work on
the card (launches, copies, sets) from inside
``repro_torch.sim.epoch.observe`` (the monitoring draws, HeMem's counters,
DAMON's probes), per ``repro_torch.sim.epoch`` span."""

from tierbench.metrics._span_math import runtime_calls_per_epoch


def read(trace):
    return runtime_calls_per_epoch(trace, "repro_torch.sim.epoch.observe")
