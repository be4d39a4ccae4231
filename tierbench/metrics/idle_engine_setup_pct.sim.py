"""``idle_engine_setup_pct.sim``: the share of the traced stretch in which
the device was idle while the host set up a pass's engine, inside
``repro_torch.sim.engine_setup`` (the per-config knob arrays, HMSDK's
region maps among them, their upload, the first carry)."""

from tierbench.metrics._span_math import idle_pct


def read(trace):
    return idle_pct(trace, ["repro_torch.sim.engine_setup"])
