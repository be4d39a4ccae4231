"""``epoch_host_ms.sim``: the median host duration of a
``repro_torch.sim.epoch`` span, what it takes the host to enqueue one
epoch of the batch."""

from tierbench.metrics._span_math import epoch_host_ms


def read(trace):
    return epoch_host_ms(trace)
