"""``idle_epoch_loop_pct.sim``: the share of the traced stretch in which
the device was idle while the host was inside a ``repro_torch.sim.epoch``
span: the card waiting between launches of the eager epoch loop."""

from tierbench.metrics._span_math import EPOCH, idle_pct


def read(trace):
    return idle_pct(trace, [EPOCH])
