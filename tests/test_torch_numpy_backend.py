"""The port's numpy backend and the ``exact_select=False`` ablation against
the reference package, on the CPU.

* ``run_simulation_batch(..., backend="numpy")`` is the reference's numpy
  epoch loop bit for bit: every ``SimResult`` field (walls, migrations,
  hit rates, sampling and stall ms, heatmap and placement) of all five
  engines and kv-hemem under both samplers, B = 3 (the default config and
  two sampled ones) with a seed per config, at scale 0.04;
* the eight Fig. 2 workloads, built as ``benchmarks/fig2_best_vs_default.py``
  builds them (with ``workers=1``) and carried over through
  ``ExperimentSpec.from_dict(ref_spec.to_dict())``, replay bitwise;
* ``workers=2`` is bitwise ``workers=1``; a numpy engine registered
  through the port's ``register_engine`` runs under ``backend="numpy"``
  and falls back with one warning under the default backend (walls within
  1e-5 of numpy's, ``tests/test_jax_backend.py``'s bar); the
  deterministic engines agree across backends (bitwise migrations, walls
  within 1e-4); ``crn=True`` with numpy raises;
* the quantized selection's masks are bitwise the reference's, and the
  oracle's and static's ``Study.run(exact_select=False)`` migrations
  equal the reference's ``backend="jax", exact_select=False``.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core as R  # noqa: E402
from repro.core import engine_jax  # noqa: E402
from repro.core import simulator as rsim  # noqa: E402
from repro.core import workloads as rwl  # noqa: E402
from repro.core.knobs import get_space as ref_space  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import engine_torch, registry  # noqa: E402
from repro_torch.core import simulator as psim  # noqa: E402
from repro_torch.core import workloads as pwl  # noqa: E402
from repro_torch.core.knobs import get_space  # noqa: E402

FIELDS = ("total_s", "epoch_wall_ms", "cum_migrations", "fast_hit_rate",
          "sampling_ms", "stall_ms", "heatmap", "placement")
ENGINES = ("hemem", "hmsdk", "memtis", "static", "oracle", "kv-hemem")
#: the workloads of ``benchmarks/common.py``'s SUITE (Fig. 2)
FIG2 = [("gapbs-bc", "kron"), ("gapbs-pr", "kron"), ("gapbs-cc", "kron"),
        ("silo", "ycsb-c"), ("btree", ""), ("xsbench", ""),
        ("gups", "8GiB-hot"), ("graph500", "kron")]


def _configs(engine, n=3, seed=5):
    space_name = "hemem" if engine == "kv-hemem" else engine
    if space_name in ("hemem", "hmsdk", "memtis"):
        space = get_space(space_name)
        rng = np.random.default_rng(seed)
        return [space.default_config()] + [space.sample(rng)
                                           for _ in range(n - 1)]
    return [{} for _ in range(n)]


def _assert_results_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            if y is None:
                assert x is None, f
            else:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                              err_msg=f)


@pytest.mark.parametrize("sampler", ["sparse", "elementwise"])
@pytest.mark.parametrize("engine", ENGINES)
def test_numpy_backend_is_the_reference_field_by_field(engine, sampler):
    name = "kv-poisson" if engine == "kv-hemem" else "gups"
    inp = "" if engine == "kv-hemem" else "8GiB-hot"
    kw = dict(seeds=[7, 8, 9], sampler=sampler, record_heatmap=True,
              heat_bins=64)
    ref = rsim.run_simulation_batch(
        rwl.make_workload(name, inp, threads=8, scale=0.04, seed=3), engine,
        _configs(engine), "pmem-large", **kw)
    ours = psim.run_simulation_batch(
        pwl.make_workload(name, inp, threads=8, scale=0.04, seed=3), engine,
        _configs(engine), "pmem-large", backend="numpy", **kw)
    _assert_results_equal(ours, ref)


@pytest.mark.parametrize("workload,input_name", FIG2)
def test_fig2_specs_replay_bitwise(workload, input_name):
    ref_spec = R.ExperimentSpec(
        engine="hemem", workload=R.WorkloadSpec(workload, input_name),
        options=R.SimOptions(sampler="sparse", workers=1))
    spec = P.ExperimentSpec.from_dict(ref_spec.to_dict())
    assert spec.options.backend == "numpy" and spec.options.workers == 1
    assert spec.to_dict()["workload"] == ref_spec.to_dict()["workload"]
    sampled = ref_space("hemem").sample(np.random.default_rng(11))
    configs = [ref_spec.engine.config, sampled]
    ref = R.Study(ref_spec).run(configs=configs)
    ours = P.Study(spec).run(configs=configs)
    _assert_results_equal(ours, ref)
    assert P.Study(spec).run().total_s == R.Study(ref_spec).run().total_s


@pytest.mark.parametrize("cells", [1, 2])
def test_sharding_is_bitwise_one_worker(cells):
    wl = pwl.make_workload("gups", "8GiB-hot", threads=8, scale=0.04, seed=3)
    grid = [(wl, "hemem", _configs("hemem", 5)),
            (wl, "memtis", _configs("memtis", 3))][:cells]
    seeds = [list(range(1, len(c) + 1)) for _, _, c in grid]
    one = psim.run_simulation_cells(grid, seeds=seeds, sampler="sparse",
                                    backend="numpy", workers=1)
    two = psim.run_simulation_cells(grid, seeds=seeds, sampler="sparse",
                                    backend="numpy", workers=2)
    for a, b in zip(one, two):
        _assert_results_equal(a, b)


def test_custom_numpy_engine_runs_and_falls_back_with_one_warning(caplog):
    from repro_torch.core.engine import BatchStaticEngine

    @registry.register_engine("fallback-probe", overwrite=True)
    class FallbackProbeEngine(BatchStaticEngine):
        pass

    try:
        assert "fallback-probe" in registry.ENGINES
        assert "fallback-probe" not in registry.COMPILED
        spec = P.ExperimentSpec(
            engine="fallback-probe",
            workload=P.WorkloadSpec("gups", threads=8, scale=0.02),
            options=P.SimOptions(seed=3, backend="numpy"))
        numpy_run = P.Study(spec).run()
        psim._TORCH_FALLBACK_WARNED.clear()
        torch_spec = P.ExperimentSpec.from_dict(dict(
            spec.to_dict(), options=dict(seed=3, device="cpu")))
        with caplog.at_level(logging.WARNING,
                             logger="repro_torch.core.simulator"):
            fell = P.Study(torch_spec).run()
            P.Study(torch_spec).run()
        msgs = [r.message for r in caplog.records
                if "falling back to the numpy epoch loop" in r.message]
        assert len(msgs) == 1 and "fallback-probe" in msgs[0]
        np.testing.assert_allclose(fell.epoch_wall_ms,
                                   numpy_run.epoch_wall_ms, rtol=1e-5)
        np.testing.assert_array_equal(fell.cum_migrations,
                                      numpy_run.cum_migrations)
    finally:
        registry.ENGINES.unregister("fallback-probe")


@pytest.mark.parametrize("case", ["above-ceiling", "numpy-sampler",
                                  "segment"])
def test_builtin_engine_never_falls_back_to_the_host(case, monkeypatch):
    """Under the default backend a builtin (compiled) engine that the
    compiled loop does not cover is refused, as ``run_epochs`` refuses it:
    the numpy loop is never entered and nothing warns."""
    def host_loop(*a, **k):
        raise AssertionError("the numpy epoch loop ran on the host")

    monkeypatch.setattr(psim, "make_batch_engine", host_loop)
    monkeypatch.setattr(psim, "_warn_torch_fallback", host_loop)
    sampler = "elementwise"
    if case == "numpy-sampler":
        registry.register_sampler("host-only-probe",
                                  registry.SAMPLERS.get("elementwise"),
                                  overwrite=True)
        sampler = "host-only-probe"
        workload = P.WorkloadSpec("gups", threads=8, scale=0.02)
    else:
        workload = P.WorkloadSpec("gapbs-bc", "kron", threads=12, scale=12.0)
    try:
        spec = P.ExperimentSpec(
            engine="hemem", workload=workload,
            options=P.SimOptions(seed=0, sampler=sampler, device="cpu"))
        study = P.Study(spec)
        if case == "above-ceiling":
            assert study.workload().n_pages > engine_torch.MAX_PAGES
        with pytest.raises(ValueError, match="does not cover"):
            if case == "segment":
                psim.run_simulation_segment(
                    study.workload(), "hemem", [{}], epoch_stop=2,
                    device="cpu")
            else:
                study.run()
    finally:
        if case == "numpy-sampler":
            registry.SAMPLERS.unregister("host-only-probe")


def test_compiled_and_numpy_definitions_share_a_name():
    """``register_engine`` files an EngineDef as the compiled definition
    and a numpy class as the numpy engine; a name may hold both."""
    from repro_torch.core.engine import BatchStaticEngine

    @registry.register_engine("both-probe")
    class BothNumpy(BatchStaticEngine):
        pass

    @registry.register_engine("both-probe")
    class BothDef(engine_torch.StaticDef):
        pass

    try:
        assert registry.ENGINES.get("both-probe") is BothNumpy
        assert registry.COMPILED.get("both-probe") is BothDef
        assert engine_torch.supports("both-probe", "elementwise")
        wl = pwl.make_workload("gups", "", threads=8, scale=0.02, seed=0)
        a = psim.run_simulation_batch(wl, "both-probe", [{}],
                                      backend="numpy")[0]
        b = psim.run_simulation_batch(wl, "both-probe", [{}],
                                      device="cpu")[0]
        np.testing.assert_array_equal(a.cum_migrations, b.cum_migrations)
        with pytest.raises(KeyError, match="did you mean 'both-probe'"):
            P.EngineSpec("both-prob")
    finally:
        registry.ENGINES.unregister("both-probe")
        registry.COMPILED.unregister("both-probe")


@pytest.mark.parametrize("engine", ["static", "oracle"])
def test_deterministic_engines_agree_across_backends(engine):
    wl = pwl.make_workload("gups", "8GiB-hot", threads=8, scale=0.04, seed=3)
    a = psim.run_simulation_batch(wl, engine, [{}], seeds=7,
                                  backend="numpy")[0]
    b = psim.run_simulation_batch(wl, engine, [{}], seeds=7,
                                  device="cpu")[0]
    np.testing.assert_array_equal(a.cum_migrations, b.cum_migrations)
    assert abs(a.total_s - b.total_s) / a.total_s < 1e-4


def test_crn_with_numpy_raises():
    with pytest.raises(ValueError, match="crn"):
        P.SimOptions(crn=True, backend="numpy")
    wl = pwl.make_workload("gups", "", threads=8, scale=0.02, seed=0)
    with pytest.raises(ValueError, match="crn"):
        psim.run_simulation_batch(wl, "hemem", _configs("hemem", 2),
                                  backend="numpy", crn=True)
    with pytest.raises(ValueError, match="crn"):
        psim.run_simulation_segment(wl, "hemem", _configs("hemem", 2),
                                    backend="numpy", crn=True)


def test_numpy_segments_are_prefixes():
    wl = pwl.make_workload("gups", "", threads=8, scale=0.02, seed=0)
    cfgs = _configs("hemem", 2)
    whole = psim.run_simulation_batch(wl, "hemem", cfgs, seeds=[1, 2],
                                      sampler="sparse", backend="numpy")
    seg = psim.run_simulation_segment(wl, "hemem", cfgs, seeds=[1, 2],
                                      backend="numpy", epoch_stop=17)
    ref = rsim.run_simulation_segment(
        rwl.make_workload("gups", "", threads=8, scale=0.02, seed=0),
        "hemem", cfgs, seeds=[1, 2], epoch_stop=17)
    np.testing.assert_array_equal(seg["wall_ms"], ref["wall_ms"])
    np.testing.assert_array_equal(
        seg["wall_ms"], np.stack([r.epoch_wall_ms[:17] for r in whole], 1))
    assert seg["carry"] is None
    with pytest.raises(ValueError, match="checkpointed"):
        psim.run_simulation_segment(wl, "hemem", cfgs, backend="numpy",
                                    epoch_start=5, epoch_stop=10)


@pytest.mark.parametrize("ref_opts", [
    {},
    dict(backend="jax", crn=True, exact_select=False),
    dict(sampler="sparse", workers="auto"),
    dict(seed=4, record_heatmap=True, heat_bins=32, workers=3),
])
def test_sim_options_read_every_reference_dict(ref_opts):
    ref = R.SimOptions(**ref_opts)
    ours = P.SimOptions.from_dict(ref.to_dict())
    d = ref.to_dict()
    for k, v in d.items():
        want = "torch" if (k, v) == ("backend", "jax") else v
        assert getattr(ours, k) == want, k
    assert P.SimOptions.from_dict(ours.to_dict()) == ours


def test_default_options_run_on_the_card():
    """A Study with default options runs on the card, and raises where
    there is none -- it never runs on the CPU instead."""
    opts = P.SimOptions()
    assert (opts.backend, opts.device, opts.workers,
            opts.exact_select) == ("torch", "cuda", 1, True)
    if torch.cuda.is_available():
        return
    spec = P.ExperimentSpec(engine="static",
                            workload=P.WorkloadSpec("gups", scale=0.02))
    with pytest.raises(RuntimeError, match="cuda"):
        P.Study(spec).run()


# ---------------------------------------------------------------------------
# the exact_select=False ablation
# ---------------------------------------------------------------------------
def test_log_is_bitwise_the_reference_log():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(1, 10, 200_000),
                        1 + np.exp(rng.uniform(-12, 30, 200_000)),
                        np.arange(1, 70_000)]).astype(np.float32)
    engine_jax.have_jax()
    ref = np.asarray(jax.numpy.log(jax.numpy.asarray(x)))
    np.testing.assert_array_equal(
        engine_torch.log_f32(torch.from_numpy(x)).numpy(), ref)
    assert np.float32(np.asarray(jax.numpy.log(np.float32(2.0)))) == \
        np.float32(engine_torch._LN2)


@pytest.mark.parametrize("seed", range(6))
def test_quantized_masks_are_the_reference_masks(seed):
    engine_jax.have_jax()
    rng = np.random.default_rng(seed)
    B, n = int(rng.integers(1, 5)), int(rng.integers(2, 3000))
    if seed % 3 == 0:  # many ties
        ph = rng.integers(0, 20, (B, n)).astype(np.float32)
    elif seed % 3 == 1:
        ph = rng.exponential(50.0, (B, n)).astype(np.float32)
    else:  # a few very hot pages
        ph = np.round(rng.lognormal(2.0, 3.0, (B, n))).astype(np.float32)
    dh = np.where(rng.uniform(size=(B, n)) < 0.3, ph,
                  rng.integers(0, 5, (B, n))).astype(np.float32)
    pm = rng.uniform(size=(B, n)) < 0.5
    dm = rng.uniform(size=(B, n)) < 0.5
    kp = rng.integers(0, n + 1, B).astype(np.float32)
    kd = rng.integers(0, n + 1, B).astype(np.float32)
    args = (pm, ph, dm, dh, kp, kd)
    ours = engine_torch.select_top_quantized(
        *(torch.from_numpy(a) for a in args))
    for fn in (engine_jax.select_top_quantized,
               jax.jit(engine_jax.select_top_quantized)):
        ref = fn(*(jax.numpy.asarray(a) for a in args))
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("engine", ["static", "oracle"])
def test_quantized_study_migrations_are_the_reference(engine):
    def spec(pkg, **opts):
        return pkg.ExperimentSpec(
            engine=engine,
            workload=pkg.WorkloadSpec("gups", "8GiB-hot", threads=8,
                                      scale=0.04),
            options=pkg.SimOptions(seed=3, exact_select=False, **opts))
    ref = R.Study(spec(R, backend="jax")).run()
    ours = P.Study(spec(P, device="cpu")).run()
    np.testing.assert_array_equal(ours.cum_migrations, ref.cum_migrations)
    np.testing.assert_allclose(ours.epoch_wall_ms, ref.epoch_wall_ms,
                               rtol=1e-4)


def test_quantized_route_launches_no_selection():
    """Under ``exact_select=False`` the plan never calls the selection
    wrapper (whose count moves on every call that reaches it)."""
    from repro_torch.kernels import ops
    wl = pwl.make_workload("gups", "8GiB-hot", threads=8, scale=0.02, seed=3)
    calls = []
    real = ops.select_topk

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    ops.select_topk = counting
    try:
        q = psim.run_simulation_batch(wl, "hemem", _configs("hemem", 2),
                                      device="cpu", exact_select=False)
        assert not calls
        e = psim.run_simulation_batch(wl, "hemem", _configs("hemem", 2),
                                      device="cpu")
        assert len(calls) == wl.n_epochs
    finally:
        ops.select_topk = real
    for a, b in zip(q, e):
        assert np.isfinite(a.total_s) and a.total_s > 0
        assert abs(a.total_s - b.total_s) / b.total_s < 0.5


def test_tune_service_takes_numpy_specs_and_online_refuses_them():
    """As in the reference: the async service runs a numpy spec (its units
    re-run from epoch 0, no carry), bitwise the synchronous study; the
    online tuner needs the compiled loop's CRN segments."""
    def spec(pkg, **opts):
        return pkg.ExperimentSpec(
            engine="hemem",
            workload=pkg.WorkloadSpec("gups", threads=8, scale=0.02),
            options=pkg.SimOptions(seed=1, **opts))
    kw = dict(budget=5, seed=3, n_init=3)
    study = P.Study(spec(P, backend="numpy", device="cpu"))
    sync = study.tune(**kw)
    asyn = study.tune(executor="async", slots=1, **kw)
    ref = R.Study(spec(R)).tune(**kw)
    assert [o.value for o in asyn.history] == \
        [o.value for o in sync.history] == [o.value for o in ref.history]
    with pytest.raises(ValueError, match="compiled backend"):
        study.tune(online=True, window_epochs=10, budget=4)
    with pytest.raises(ValueError, match="compiled backend"):
        R.Study(spec(R)).tune(online=True, window_epochs=10, budget=4)
