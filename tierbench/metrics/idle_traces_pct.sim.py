"""``idle_traces_pct.sim``: the share of the traced stretch in which the
device was idle while the host built a pass's trace: inside
``repro_torch.workload.build`` (the workload generator, on a ``Study``'s
first run) or ``repro_torch.sim.trace_upload`` (each epoch's accesses,
stacked and copied to the card)."""

from tierbench.metrics._span_math import idle_pct


def read(trace):
    return idle_pct(trace, ["repro_torch.workload.build",
                            "repro_torch.sim.trace_upload"])
