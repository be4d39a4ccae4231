"""Whole runs of the harness on the CPU at a small scale with the timed
path broken underneath: each fault a cell can have makes ``correct``
false.  The cells run on one card, so no exchange between cards can be
left out."""

import pytest
import torch

from tierbench import generate
from tierbench.tests.cpu import cpu_run

CELLS = ["gups-hemem.grid", "gapbs-pr-hmsdk.sweep"]


@pytest.fixture
def small_run(monkeypatch):
    """A run at a small scale on one thread, with every eighth
    configuration of a pass and the last."""
    full = generate.pass_configs

    def thin(config, traffic, seed):
        cfgs = full(config, traffic, seed)
        return cfgs[:-1:8] + cfgs[-1:]
    monkeypatch.setattr(generate, "pass_configs", thin)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield lambda cell: cpu_run(cell, 2 ** 32 + 11,
                               setattr_=monkeypatch.setattr)
    torch.set_num_threads(threads)


def _state_unchanged(monkeypatch):
    """The engine's observe step hands its state back unchanged."""
    from repro_torch.core import engine_torch as et
    for cls in (et.HeMemDef, et.HMSDKDef):
        orig = cls.observe

        def observe(self, st, *a, _orig=orig, **k):
            return st, _orig(self, st, *a, **k)[1]
        monkeypatch.setattr(cls, "observe", observe)


def _half_batch(monkeypatch):
    """Half of the batch simulated; the other half given its mean."""
    import numpy as np
    from repro_torch.core import study
    orig = study.run_simulation_batch

    def run(workload, engine, configs, *a, **k):
        half = orig(workload, engine, configs[:len(configs) // 2], *a, **k)
        mean = half[0].__class__(**{
            **half[0].__dict__,
            "total_s": float(np.mean([r.total_s for r in half])),
            "cum_migrations": np.mean([r.cum_migrations for r in half], 0),
            "fast_hit_rate": np.mean([r.fast_hit_rate for r in half], 0)})
        return half + [mean] * (len(configs) - len(half))
    monkeypatch.setattr(study, "run_simulation_batch", run)


def _answer_altered(monkeypatch):
    """The migration selection ranks promotions by the wrong sign."""
    from repro_torch.core import engine_torch as et
    orig = et.kernel_ops.select_topk

    def select(p_mask, p_heat, d_mask, d_heat, n_p, n_d):
        return orig(p_mask, -p_heat, d_mask, d_heat, n_p, n_d)
    monkeypatch.setattr(et.kernel_ops, "select_topk", select)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(cell, fault, monkeypatch, small_run):
    fault(monkeypatch)
    r = small_run(cell)
    assert r["correct"] is False and r["failed"] > 0
