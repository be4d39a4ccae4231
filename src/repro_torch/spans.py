"""Named host spans of the simulator's layers, on the profiler's clock.

``with span("repro_torch.sim.epoch"): ...`` is a
``torch.profiler.record_function`` range while a profiler records, and a
shared no-op context otherwise: the recording profiler is the switch (no
option, no environment variable), and its trace is the export.  Unguarded,
``record_function`` costs an operator call per span even with no profiler
recording; the guard costs one flag read.

The span tree of one ``Study.run`` pass (spans nest on one thread; a
reader groups them by containment)::

    repro_torch.study.run                 Study.run
      repro_torch.workload.build          Study.workload's build (cache miss)
      repro_torch.sim.trace_upload        the trace built, stacked, uploaded
      repro_torch.sim.engine_setup        knobs, upload, carry, step
      repro_torch.sim.epoch               one epoch step (E a pass)
        repro_torch.sim.epoch.first_touch
        repro_torch.sim.epoch.observe
        repro_torch.sim.epoch.plan
          repro_torch.sim.epoch.select
        repro_torch.sim.epoch.cost
      repro_torch.sim.results             results to the host, SimResult rows
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a host span while a
    profiler records, and does nothing otherwise."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
