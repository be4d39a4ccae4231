"""The PyTorch port's Study front-end against the JAX reference's, on the
CPU: the same spec and optimizer seed through ``repro.core.study.Study``
(``backend="jax"``) and ``repro_torch.core.study.Study`` (``device="cpu"``).

The optimizer is numpy in both packages, so the configs it suggests from
the same seed are bitwise equal wherever they do not depend on evaluated
values — the whole initial design here (budget 16 < n_init 20).  The
incumbent's ``total_s`` is held within 1%: the simulations agree to the
tolerances of ``tests/test_torch_engine.py``, and a near-tie between two
configs may pick a different incumbent.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import specs as jax_specs  # noqa: E402
from repro.core.study import Study as JaxStudy  # noqa: E402
from repro_torch.core import (EngineSpec, ExperimentSpec, SimOptions,  # noqa: E402
                              Study, WorkloadSpec)

SCALE = 0.02


def _spec(engine="hemem", **opts):
    return ExperimentSpec(
        engine=engine,
        workload=WorkloadSpec("gups", "8GiB-hot", threads=8, scale=SCALE),
        options=SimOptions(seed=3, crn=True, device="cpu", **opts))


def _jax_spec(engine="hemem"):
    return jax_specs.ExperimentSpec(
        engine=engine,
        workload=jax_specs.WorkloadSpec("gups", "8GiB-hot", threads=8,
                                        scale=SCALE),
        options=jax_specs.SimOptions(seed=3, crn=True, backend="jax"))


def test_tune_matches_reference_study():
    ours = Study(_spec()).tune(budget=16, batch_size=8, seed=0)
    ref = JaxStudy(_jax_spec()).tune(budget=16, batch_size=8, seed=0)
    assert len(ours.history) == len(ref.history) == 16
    # the initial design: default config + seeded random configs
    assert [o.config for o in ours.history] == [o.config for o in ref.history]
    assert ours.history[0].config == EngineSpec("hemem").config
    assert abs(ours.best_value - ref.best_value) <= 0.01 * ref.best_value
    assert abs(ours.default_value - ref.default_value) \
        <= 1e-3 * ref.default_value
    assert len(ours.round_times) == 2


def test_run_matches_reference_study_on_deterministic_engine():
    ours = Study(_spec("static")).run()
    ref = JaxStudy(_jax_spec("static")).run()
    np.testing.assert_array_equal(ours.cum_migrations, ref.cum_migrations)
    np.testing.assert_allclose(ours.epoch_wall_ms, ref.epoch_wall_ms,
                               rtol=1e-5)
    assert ours.workload == ref.workload and ours.machine == ref.machine


def test_run_batch_and_heatmap_shapes():
    cfgs = [EngineSpec("hemem").config,
            EngineSpec("hemem", {"read_hot_threshold": 3}).config]
    res = Study(_spec(record_heatmap=True, heat_bins=16)).run(configs=cfgs)
    assert len(res) == 2
    for r in res:
        assert r.epoch_wall_ms.shape == (60,) and np.isfinite(r.total_s)
        assert r.heatmap.shape == (60, 16) and r.placement.shape == (60, 16)
        assert ((r.placement >= 0) & (r.placement <= 1)).all()


def test_spec_round_trip_and_defaults():
    spec = _spec()
    assert ExperimentSpec.from_dict(spec.to_dict()) == spec
    assert SimOptions().device == "cuda"
    with pytest.raises(KeyError, match="did you mean"):
        EngineSpec("hemme")
    with pytest.raises(KeyError):
        SimOptions(sampler="nope")


def test_workload_scale_past_the_paper_deployment():
    """The port's spec takes scale > 1 (the reference's stops at 1): gapbs-bc
    on kron at 1.7 is 68,004 pages, past the old 65,535-page ceiling."""
    spec = ExperimentSpec(
        engine="hemem", workload=WorkloadSpec("gapbs-bc", "kron", scale=1.7),
        options=SimOptions(device="cpu"))
    assert Study(spec).workload().n_pages == 68_004
    with pytest.raises(ValueError, match=r"\(0, 1\]"):
        jax_specs.WorkloadSpec("gapbs-bc", "kron", scale=1.7)
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="positive"):
            WorkloadSpec("gapbs-bc", "kron", scale=bad)
