"""The port's deprecated loose-kwargs shims against the reference's, on the
CPU: every legacy entry point warns with its ``repro_torch.`` name and
returns the reference shim's result bit for bit (both run the numpy
backend, as the reference's shims do), and the typed API never warns.
The seven cases of ``tests/test_shims.py``, plus ``grid_search`` and
``Scenario.objective_batch``.
"""

import warnings

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core as R  # noqa: E402
from repro_torch.core import (ExperimentSpec, SimOptions, Study,  # noqa: E402
                              WorkloadSpec)
from repro_torch.core.pages import TierState  # noqa: E402

SCALE = 0.02


def _study(engine="hemem", **opts):
    return Study(ExperimentSpec(
        engine=engine, workload=WorkloadSpec("gups", scale=SCALE),
        options=SimOptions(backend="numpy", device="cpu", **opts)))


def _ref_study(engine="hemem", **opts):
    return R.Study(R.ExperimentSpec(
        engine=engine, workload=R.WorkloadSpec("gups", scale=SCALE),
        options=R.SimOptions(**opts)))


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kw)


def test_evaluate_warns_and_matches():
    from repro.core.simulator import evaluate as ref_evaluate
    from repro_torch.core.simulator import evaluate
    with pytest.warns(DeprecationWarning,
                      match="^repro_torch.core.simulator.evaluate"):
        legacy = evaluate("hemem", None, "gups", scale=SCALE, seed=4)
    assert legacy == _study(seed=4).run().total_s
    assert legacy == _quiet(ref_evaluate, "hemem", None, "gups",
                            scale=SCALE, seed=4)


def test_evaluate_batch_warns_and_matches():
    from repro.core.simulator import evaluate_batch as ref_evaluate_batch
    from repro_torch.core.knobs import HEMEM_SPACE
    from repro_torch.core.simulator import evaluate_batch
    cfgs = [HEMEM_SPACE.default_config(),
            HEMEM_SPACE.validate({"migration_period": 100})]
    with pytest.warns(DeprecationWarning, match="evaluate_batch"):
        legacy = evaluate_batch("hemem", cfgs, "gups", scale=SCALE, seed=4)
    new = [r.total_s for r in
           _study(seed=4, sampler="sparse").run(configs=cfgs)]
    assert legacy == new
    assert legacy == _quiet(ref_evaluate_batch, "hemem", cfgs, "gups",
                            scale=SCALE, seed=4)


def test_run_simulation_warns_and_matches():
    from repro.core.simulator import run_simulation as ref_run_simulation
    from repro.core.workloads import make_workload as ref_make_workload
    from repro_torch.core.simulator import run_simulation
    from repro_torch.core.workloads import make_workload
    wl = make_workload("gups", "", threads=12, scale=SCALE, seed=0)
    with pytest.warns(DeprecationWarning,
                      match="^repro_torch.core.simulator.run_simulation"):
        legacy = run_simulation(wl, "static", {}, "pmem-large", seed=0)
    new = Study(ExperimentSpec(
        engine="static", workload=WorkloadSpec("gups", threads=12,
                                               scale=SCALE),
        options=SimOptions(backend="numpy"))).run()
    assert legacy.total_s == new.total_s
    np.testing.assert_array_equal(legacy.epoch_wall_ms, new.epoch_wall_ms)
    ref = _quiet(ref_run_simulation,
                 ref_make_workload("gups", "", threads=12, scale=SCALE,
                                   seed=0), "hemem", None, "pmem-large",
                 seed=0)
    ours = _quiet(run_simulation, wl, "hemem", None, "pmem-large", seed=0)
    np.testing.assert_array_equal(ours.epoch_wall_ms, ref.epoch_wall_ms)
    np.testing.assert_array_equal(ours.cum_migrations, ref.cum_migrations)


def test_make_engine_warns_and_builds_wrapper():
    from repro.core.engine import make_engine as ref_make_engine
    from repro.core.pages import TierState as RefTierState
    from repro_torch.core.engine import HeMemEngine, make_engine
    from repro_torch.core.knobs import HEMEM_SPACE
    tier = TierState(64, 8)
    with pytest.warns(DeprecationWarning,
                      match="^repro_torch.core.engine.make_engine"):
        eng = make_engine("hemem", HEMEM_SPACE.default_config(), tier)
    assert isinstance(eng, HeMemEngine)
    with pytest.warns(DeprecationWarning), pytest.raises(KeyError):
        make_engine("hemen", {}, TierState(64, 8))
    # the wrapper steps bitwise the reference's
    from repro_torch.core.knobs import HMSDK_SPACE
    cfg = HMSDK_SPACE.validate({"nr_regions": 8})
    ref = _quiet(ref_make_engine, "hmsdk", cfg, RefTierState(64, 8), seed=2)
    ours = _quiet(make_engine, "hmsdk", cfg, TierState(64, 8), seed=2)
    rng = np.random.default_rng(0)
    for _ in range(5):
        reads = rng.poisson(3.0, 64).astype(np.float64)
        writes = rng.poisson(1.0, 64).astype(np.float64)
        for e in (ref, ours):
            e.tier.allocate_first_touch(reads + writes > 0)
            e.observe(reads, writes, 20.0)
        a, b = ref.plan(20.0, 8), ours.plan(20.0, 8)
        np.testing.assert_array_equal(a.promote, b.promote)
        np.testing.assert_array_equal(a.demote, b.demote)
        ref.tier.apply(a)
        ours.tier.apply(b)
        np.testing.assert_array_equal(ref.nr_accesses, ours.nr_accesses)


def test_scenario_warns_and_objective_matches():
    from repro.core.simulator import Scenario as RefScenario
    from repro_torch.core.simulator import Scenario
    with pytest.warns(DeprecationWarning,
                      match="^repro_torch.core.simulator.Scenario"):
        sc = Scenario("gups", "", scale=SCALE, seed=6)
    cfg = _study().spec.engine.config
    assert sc.objective("hemem")(cfg) == _study(seed=6).run().total_s
    ref = _quiet(RefScenario, "gups", "", scale=SCALE, seed=6)
    assert sc.objective("hemem")(cfg) == ref.objective("hemem")(cfg)
    assert sc.key == ref.key


def test_scenario_objective_batch_matches():
    from repro.core.simulator import Scenario as RefScenario
    from repro_torch.core.knobs import HMSDK_SPACE
    from repro_torch.core.simulator import Scenario
    cfgs = [HMSDK_SPACE.default_config(),
            HMSDK_SPACE.validate({"nr_regions": 40})]
    sc = _quiet(Scenario, "silo", "ycsb-c", scale=SCALE, seed=2)
    ref = _quiet(RefScenario, "silo", "ycsb-c", scale=SCALE, seed=2)
    assert sc.objective_batch("hmsdk")(cfgs) == \
        ref.objective_batch("hmsdk")(cfgs)


def test_tune_scenario_warns_and_matches():
    from repro.core.bo.tuner import tune_scenario as ref_tune_scenario
    from repro.core.simulator import Scenario as RefScenario
    from repro_torch.core.bo.tuner import tune_scenario
    from repro_torch.core.simulator import Scenario
    with pytest.warns(DeprecationWarning):
        sc = Scenario("gups", "", scale=SCALE)
        legacy = tune_scenario("hemem", sc, budget=4, seed=2)
    res = _study().tune(budget=4, seed=2)
    assert [o.value for o in legacy.history] == \
        [o.value for o in res.history]
    ref = _quiet(ref_tune_scenario, "hemem",
                 _quiet(RefScenario, "gups", "", scale=SCALE), budget=4,
                 seed=2)
    assert [(o.config, o.value) for o in legacy.history] == \
        [(o.config, o.value) for o in ref.history]


def test_grid_search_warns_and_matches():
    from repro.core.bo.smac import grid_search as ref_grid_search
    from repro_torch.core.bo.smac import grid_search
    from repro_torch.core.knobs import HEMEM_SPACE
    study = _study(seed=1)
    knobs = {"migration_period": [10, 100], "cooling_threshold": [6, 18]}

    def objective(cfg):
        return study.run(configs=[cfg])[0].total_s

    with pytest.warns(DeprecationWarning,
                      match="^repro_torch.core.bo.smac.grid_search"):
        best, val, table = grid_search(HEMEM_SPACE, objective, knobs)
    ref_study = _ref_study(seed=1)
    ref = _quiet(ref_grid_search, HEMEM_SPACE,
                 lambda c: ref_study.run(configs=[c])[0].total_s, knobs)
    assert (best, val, table) == ref
    assert len(table) == 4 and val == min(table.values())


def test_new_api_does_not_warn():
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        st = _study(seed=1)
        st.run()
        st.tune(budget=2, seed=1)
        st.sweep(engines=["static"])
