"""``idle_results_pct.sim``: the share of the traced stretch in which the
device was idle while the host was inside ``repro_torch.sim.results``: the
per-epoch outputs stacked and read back, and a ``SimResult`` built per
configuration."""

from tierbench.metrics._span_math import idle_pct


def read(trace):
    return idle_pct(trace, ["repro_torch.sim.results"])
