"""The port's Bayesian-optimisation surface against the JAX reference's, on
the CPU: knob spaces, the forest grower (against both of the reference's),
``ops.topk_mask``, the fused acquisition, SMAC's suggestion histories,
``knob_importance``, ``Study.tune`` and ``Study.sweep``.

Tolerances:

* Knob spaces, forests, selection masks, SMAC histories and importance
  scores are numpy (or integer) computations copied from the reference:
  bitwise.
* The torch acquisition follows the reference's jitted one (JAX without
  x64): float32 descent compares and moments, the exact erf.  Its EI is
  held within rtol 1e-5 and atol 1e-6 of ``_acquire_jax``'s (the two
  frameworks' erf and reductions differ in the last ulps; measured
  differences ~1e-7 absolute); its selections equal the reference's and
  the numpy path's on these seeded cases at q <= 6, the reference's own
  bar for its jax path (``tests/test_bo.py``).  At q = 40 of a 96-row pool
  the selection reaches EIs of ~1e-8, where ``1 + erf(z)`` cancels below
  float32's resolution and the three paths differ by ~1e-7 absolute: there
  a position may differ only between candidates whose EIs lie within that
  EI tolerance of each other.  A candidate exactly on a split point of an
  integer knob goes left in float32 (both jitted paths) and may go right
  in numpy's float64 (``test_split_point_ties_...``).
* ``Study.sweep`` simulates through the epoch loop, so its cells carry the
  bars of ``tests/test_torch_engine.py``: deterministic engines'
  migrations bitwise and walls within 1e-5, sampled engines' migrations
  within 1% and ``total_s`` within 1e-3; each cell is bitwise equal to the
  port's own ``Study.run``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import specs as jax_specs  # noqa: E402
from repro.core import knobs as ref_knobs  # noqa: E402
from repro.core.bo import forest_fast as ref_ff  # noqa: E402
from repro.core.bo import rf as ref_rf  # noqa: E402
from repro.core.bo import smac as ref_smac  # noqa: E402
from repro.core.bo.importance import knob_importance as ref_importance  # noqa: E402
from repro.core.study import Study as JaxStudy  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import (EngineSpec, ExperimentSpec, SimOptions,  # noqa: E402
                              Study, SweepResult, WorkloadSpec)
from repro_torch.core import knobs  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core.bo import forest_fast, rf, smac  # noqa: E402
from repro_torch.core.bo import knob_importance  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import select_topk as sk  # noqa: E402

SPACES = ("hemem", "hmsdk", "memtis")
WALL_RTOL = 1e-5        # deterministic engines, per epoch
TOTAL_RTOL = 1e-3       # sampled engines, total_s
MIG_RTOL = 0.01         # sampled engines, final cum_migrations
EI_RTOL, EI_ATOL = 1e-5, 1e-6


@pytest.fixture
def pinned_backend():
    """Restores ``forest_fast.BACKEND`` after a test that pins it."""
    old = forest_fast.BACKEND
    yield
    forest_fast.BACKEND = old


# ---------------------------------------------------------------------------
# knob spaces
# ---------------------------------------------------------------------------


def _sample(space, rng, n):
    return [space.sample(rng) for _ in range(n)]


@pytest.mark.parametrize("name", SPACES)
def test_knob_space_methods_bitwise_on_seeded_generators(name):
    ours, ref = knobs.get_space(name), ref_knobs.get_space(name)
    assert [k.name for k in ours] == [k.name for k in ref]
    assert len(ours) == len(ref)
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    cfgs = _sample(ours, r1, 5)
    assert cfgs == _sample(ref, r2, 5)
    X = np.stack([ours.encode(c) for c in cfgs])
    assert np.array_equal(X, np.stack([ref.encode(c) for c in cfgs]))
    assert ours.decode_batch(X) == ref.decode_batch(X)
    name0 = next(iter(ours)).name
    wild = [dict(c, **{name0: 1e9}) for c in cfgs]
    assert [ours.validate(c) for c in wild] == [ref.validate(c) for c in wild]
    for scale in (0.12, 0.35):
        assert np.array_equal(ours.neighbors_batch(X[1], r1, n=9, scale=scale),
                              ref.neighbors_batch(X[1], r2, n=9, scale=scale))
    assert np.array_equal(ours.sample_batch_encoded(r1, 16),
                          ref.sample_batch_encoded(r2, 16))
    # both generators consumed the same numbers
    assert r1.uniform() == r2.uniform()


# ---------------------------------------------------------------------------
# forests
# ---------------------------------------------------------------------------


def _forest_arrays(forest):
    return (forest.feature, forest.threshold, forest.left, forest.right,
            forest.value, forest.n_nodes)


@pytest.mark.parametrize("seed", [0, 3, 9])
@pytest.mark.parametrize("ref_mode", ["reference", "fast"])
def test_forest_bit_identical_to_both_reference_growers(seed, ref_mode):
    """The port's grower against the reference's recursive one and its
    level-synchronous one, which grow the same forest."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(70, 6))
    X[:10, 2] = X[10:20, 2]          # repeated values: tied split points
    y = np.sin(4 * X[:, 0]) + X[:, 1] * X[:, 3] + 0.05 * rng.normal(size=70)
    want = ref_rf.RandomForest(seed=seed, mode=ref_mode).fit(X, y)
    got = rf.RandomForest(seed=seed).fit(X, y)
    for a, b in zip(_forest_arrays(got.forest), _forest_arrays(want.forest)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.forest.max_depth == want.forest.max_depth
    assert got.forest.feature.shape == want.forest.feature.shape
    assert (got._y_mean, got._y_std) == (want._y_mean, want._y_std)
    Xt = rng.uniform(size=(33, 6))
    for a, b in zip(got.predict_batch(Xt), want.predict_batch(Xt)):
        assert np.array_equal(a, b)


def test_the_model_phase_defaults_to_the_card():
    """With no device given, SMAC, the tuning session and ``suggest_topq``
    score on CUDA, as every entry point of the port runs on the card
    unless the caller asks for the CPU."""
    import inspect
    from repro_torch.core.bo import tuner
    assert smac.SMACOptimizer(knobs.HEMEM_SPACE).device == "cuda"
    for fn in (tuner.TuningSession.__init__, forest_fast.suggest_topq,
               forest_fast.acquisition_backend):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    session = tuner.TuningSession("hemem", _objective, batch_size=4)
    assert session.optimizer.device == "cuda"


# ---------------------------------------------------------------------------
# topk_mask: the promote side of select_topk
# ---------------------------------------------------------------------------


def _ei_case(n, seed=17):
    rng = np.random.default_rng(seed)
    ei = rng.uniform(0, 1, size=n).astype(np.float32)
    ei[::4] = ei[1]          # heavy ties
    valid = rng.uniform(size=n) < 0.8
    valid[:2] = True
    return ei, valid


@pytest.mark.parametrize("n", [40, 512, 1536])
@pytest.mark.parametrize("k", [0, 1, 5, 40, "n"])
@pytest.mark.parametrize("mode", ["ref", "pallas"])
def test_topk_mask_matches_reference(n, k, mode):
    k = n if k == "n" else k
    ei, valid = _ei_case(n)
    before = sk.launches
    for v in (valid, None):
        got = ops.topk_mask(torch.from_numpy(ei),
                            k, None if v is None else torch.from_numpy(v))
        want = np.asarray(ref_ops.topk_mask(ei, k, valid=v, mode=mode))
        assert got.dtype == torch.bool and got.shape == (n,)
        assert np.array_equal(got.numpy(), want)
        order = np.argsort(-ei, kind="stable")
        keep = order if v is None else order[v[order]]
        assert set(np.flatnonzero(got.numpy())) == set(keep[:k].tolist())
    assert sk.launches == before      # the CPU path launches nothing


# ---------------------------------------------------------------------------
# the fused acquisition
# ---------------------------------------------------------------------------


def _acq_case(seed, N, d=10):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(64, d))
    y = X[:, 0] + 0.1 * rng.normal(size=64)
    model = ref_rf.RandomForest(seed=seed).fit(X, y)
    pool = rng.uniform(size=(N, d))
    valid = rng.uniform(size=N) < 0.8
    return model, pool, float(y.min()), valid


def _assert_same_but_near_ties(got, want, ei, exact):
    """Selections equal; unless ``exact``, a position may differ between
    candidates whose EIs lie within the EI tolerance of each other."""
    assert len(got) == len(want)
    if exact:
        assert np.array_equal(got, want)
    for i in np.flatnonzero(got != want):
        a, b = float(ei[got[i]]), float(ei[want[i]])
        assert abs(a - b) <= EI_ATOL + EI_RTOL * max(abs(a), abs(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("N", [96, 512, 1536])
@pytest.mark.parametrize("q", [1, 4, 40])
def test_torch_acquisition_matches_reference_jax_path(seed, N, q):
    model, pool, best, valid = _acq_case(seed, N)
    args = (model.forest, pool, best, model._y_mean, model._y_std)
    ei_ref, sel_ref = ref_ff.suggest_topq(*args, valid=valid, q=q,
                                          backend="jax")
    # the reference's fitted forest, as it is, into the port
    ei, sel = forest_fast.suggest_topq(*args, valid=valid, q=q,
                                       backend="torch", device="cpu")
    assert ei.dtype == np.float32 and ei.shape == (N,)
    np.testing.assert_allclose(ei, ei_ref, rtol=EI_RTOL, atol=EI_ATOL)
    exact = q <= 6 or N > 96
    _assert_same_but_near_ties(sel, sel_ref, ei_ref, exact)
    _, sel_np = forest_fast.suggest_topq(*args, valid=valid, q=q,
                                         backend="numpy")
    _assert_same_but_near_ties(sel, sel_np, ei_ref, exact)
    _, sel_ref_np = ref_ff.suggest_topq(*args, valid=valid, q=q,
                                        backend="numpy")
    assert np.array_equal(sel_np, sel_ref_np)


def test_acquisition_descent_stops_at_pad_nodes():
    """A tree padded with leaves past its nodes (``feature = -1``) and a
    forest of one-node trees score as the numpy descent does."""
    model, pool, best, valid = _acq_case(4, 64)
    f = model.forest
    pad = forest_fast.FlatForest(
        feature=np.pad(f.feature, ((0, 0), (0, 9)), constant_values=-1),
        threshold=np.pad(f.threshold, ((0, 0), (0, 9))),
        left=np.pad(f.left, ((0, 0), (0, 9))),
        right=np.pad(f.right, ((0, 0), (0, 9))),
        value=np.pad(f.value, ((0, 0), (0, 9))),
        n_nodes=f.n_nodes, max_depth=f.max_depth)
    stump = forest_fast.FlatForest(
        feature=np.full((3, 1), -1), threshold=np.zeros((3, 1)),
        left=np.full((3, 1), -1), right=np.full((3, 1), -1),
        value=np.array([[0.5], [-0.5], [0.25]]), n_nodes=np.ones(3, int),
        max_depth=12)
    for forest in (pad, stump):
        args = (forest, pool, best, model._y_mean, model._y_std)
        ei_t, sel_t = forest_fast.suggest_topq(*args, valid=valid, q=5,
                                               backend="torch", device="cpu")
        ei_n, sel_n = forest_fast.suggest_topq(*args, valid=valid, q=5,
                                               backend="numpy")
        np.testing.assert_allclose(ei_t, ei_n, rtol=EI_RTOL, atol=EI_ATOL)
        assert np.array_equal(sel_t, sel_n)


def test_split_point_ties_resolve_as_the_reference_jitted_path():
    """A split between two observed values of an integer knob, 7 and 9 of
    read_hot_threshold's 1..30, lies at 8 in exact arithmetic; float64
    rounds 0.5 * (6/29 + 8/29) one ulp below 8's encoding, 7/29 (a GUPS
    tuning round on the card met this).  A candidate at 8 sits on it:
    float32 compares (the reference's jitted path and the port's torch
    path) send it left, as ``x <= thr`` does in exact arithmetic; numpy's
    float64 compare sends it right."""
    knob = knobs.HEMEM_SPACE["read_hot_threshold"]
    seven, eight, nine = (knob.to_unit(v) for v in (7.0, 8.0, 9.0))
    thr = 0.5 * (seven + nine)
    assert thr < eight and np.float32(thr) == np.float32(eight)
    T = 3
    forest = forest_fast.FlatForest(
        feature=np.tile([0, -1, -1], (T, 1)),
        threshold=np.tile([thr, 0.0, 0.0], (T, 1)),
        left=np.tile([1, -1, -1], (T, 1)), right=np.tile([2, -1, -1], (T, 1)),
        value=np.array([[0.0, -1.0, 1.0], [0.0, -0.5, 1.5], [0.0, -1.5, 0.5]]),
        n_nodes=np.full(T, 3), max_depth=12)
    pool = np.array([[nine], [eight], [seven]])
    valid = np.array([True, True, False])
    args = (forest, pool, 0.0, 1.0, 1.0)
    ei_ref, sel_ref = ref_ff.suggest_topq(*args, valid=valid, q=1,
                                          backend="jax")
    ei, sel = forest_fast.suggest_topq(*args, valid=valid, q=1,
                                       backend="torch", device="cpu")
    ei_np, sel_np = forest_fast.suggest_topq(*args, valid=valid, q=1,
                                             backend="numpy")
    np.testing.assert_allclose(ei, ei_ref, rtol=EI_RTOL, atol=EI_ATOL)
    # float32: 8 goes left with 7 (the higher EI); float64: right with 9
    assert ei[1] == ei[2] > ei[0] and ei_np[1] == ei_np[0] < ei_np[2]
    assert list(sel) == list(sel_ref) == [1] and list(sel_np) == [0]


def test_acquisition_backend_rule(pinned_backend):
    forest_fast.BACKEND = None
    assert forest_fast.acquisition_backend("cuda") == "torch"
    assert forest_fast.acquisition_backend(torch.device("cuda", 0)) == "torch"
    assert forest_fast.acquisition_backend("cpu") == "numpy"
    assert forest_fast.acquisition_backend(torch.device("cpu")) == "numpy"
    assert forest_fast.acquisition_backend(None) == "torch"
    assert forest_fast.acquisition_backend() == "torch"
    forest_fast.BACKEND = "torch"
    assert forest_fast.acquisition_backend("cpu") == "torch"
    forest_fast.BACKEND = "jax"
    with pytest.raises(ValueError, match="BACKEND"):
        forest_fast.acquisition_backend("cpu")
    forest_fast.BACKEND = None
    model, pool, best, _ = _acq_case(0, 40)
    with pytest.raises(ValueError, match="backend"):
        forest_fast.suggest_topq(model.forest, pool, best, 0.0, 1.0,
                                 backend="jax")


# ---------------------------------------------------------------------------
# SMAC
# ---------------------------------------------------------------------------


def _objective(cfg):
    return ((cfg["read_hot_threshold"] - 12) ** 2 * 0.1
            + np.log(cfg["migration_period"])
            + cfg["max_migration_rate"] * 0.05)


def _history(module, space, q, budget=32, seed=5, **kwargs):
    """``tests/test_bo.py``'s ``_history``, for either package."""
    opt = module.SMACOptimizer(space, seed=seed, n_init=6, **kwargs)
    done = 0
    while done < budget:
        cfgs = opt.ask_batch(min(q, budget - done))
        opt.tell_batch(cfgs, [_objective(c) for c in cfgs])
        done += len(cfgs)
    return [(tuple(sorted(o.config.items())), o.value)
            for o in opt.observations]


@pytest.mark.parametrize("q", [1, 8])
@pytest.mark.parametrize("surrogate", ["reference", "fast"])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_suggestion_history_matches_reference(q, surrogate, backend,
                                              pinned_backend):
    """The port's history against the reference's under each of its
    growers (the default fused acquisition)."""
    want = _history(ref_smac, ref_knobs.HEMEM_SPACE, q, surrogate=surrogate)
    forest_fast.BACKEND = backend
    got = _history(smac, knobs.HEMEM_SPACE, q, device="cpu")
    assert got == want


def test_tell_batch_crn_offsets_match_reference():
    """Rounds that re-evaluate observed configs under a shared noise
    offset: ``tell_batch(crn=True)`` debiases them as the reference's
    does, and the model rounds that follow agree."""
    space, ref_space = knobs.HEMEM_SPACE, ref_knobs.HEMEM_SPACE
    ours = smac.SMACOptimizer(space, seed=2, n_init=6, device="cpu")
    ref = ref_smac.SMACOptimizer(ref_space, seed=2, n_init=6)
    offsets = [0.0, 0.5, -0.25, 1.0, 0.125, -2.0]
    for r, off in enumerate(offsets):
        a, b = ours.ask_batch(4), ref.ask_batch(4)
        assert a == b
        if r:    # re-evaluate the incumbent and the first config seen
            a = a + [dict(ours.best.config), dict(ours.observations[0].config)]
            b = b + [dict(ref.best.config), dict(ref.observations[0].config)]
        ours.tell_batch(a, [_objective(c) + off for c in a], crn=True)
        ref.tell_batch(b, [_objective(c) + off for c in b], crn=True)
    assert [(o.config, o.value) for o in ours.observations] \
        == [(o.config, o.value) for o in ref.observations]
    # a control re-evaluated 0.5 higher debiases the whole round by 0.5
    opt = smac.SMACOptimizer(space, n_init=2, device="cpu")
    a, b = _sample(space, np.random.default_rng(1), 2)
    opt.tell_batch([a], [3.0])
    opt.tell_batch([a, b], [3.5, 7.5], crn=True)
    assert [o.value for o in opt.observations] == [3.0, 3.0, 7.0]
    opt.tell_batch([a, b], [4.0, 8.0])          # crn=False: as recorded
    assert [o.value for o in opt.observations][-2:] == [4.0, 8.0]
    with pytest.raises(ValueError):
        opt.tell_batch([a], [1.0, 2.0])


def test_random_search_surface_matches_reference():
    ours = smac.RandomSearch(knobs.HMSDK_SPACE, seed=4)
    ref = ref_smac.RandomSearch(ref_knobs.HMSDK_SPACE, seed=4)
    for q in (3, 1, 5):
        a = ours.ask_batch(q)
        b = ref.ask_batch(q)
        assert a == b
        vals = [float(len(str(c))) for c in a]
        ours.tell_batch(a, vals, crn=True)
        ref.tell_batch(b, vals, crn=True)
    assert [(o.config, o.value) for o in ours.observations] \
        == [(o.config, o.value) for o in ref.observations]
    assert ours.ask() == ref.ask()


# ---------------------------------------------------------------------------
# knob importance (§3.1, Table 5)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("surrogate", ["reference", "fast"])
def test_knob_importance_matches_reference(surrogate):
    """The port's scores against the reference's under each of its
    growers."""
    rng = np.random.default_rng(8)
    cfgs = _sample(knobs.HEMEM_SPACE, rng, 48)
    obs = [smac.Observation(c, _objective(c)) for c in cfgs]
    ref_obs = [ref_smac.Observation(c, _objective(c)) for c in cfgs]
    base = dict(read_hot_threshold=20)
    for kw in ({}, {"base": base, "n_sweep": 16, "seed": 3}):
        got = knob_importance(knobs.HEMEM_SPACE, obs, **kw)
        want = ref_importance(ref_knobs.HEMEM_SPACE, ref_obs,
                              surrogate=surrogate, **kw)
        assert got == want
        assert list(got) == list(want)       # the same order, largest first
        assert abs(sum(got.values()) - 1.0) < 1e-12
    assert next(iter(got)) in ("read_hot_threshold", "migration_period")


# ---------------------------------------------------------------------------
# Study: tune, sweep
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("surrogate,q", [
    ("fast", 8), ("reference", 1), ("fast", 4)])
def test_study_tune_options_match_reference(surrogate, q):
    kw = dict(budget=30, batch_size=q, seed=2, n_init=8,
              objective=_objective)
    ours = Study(_spec()).tune(space=knobs.HEMEM_SPACE, **kw)
    ref = JaxStudy(_jax_spec()).tune(space=ref_knobs.HEMEM_SPACE,
                                     surrogate=surrogate, **kw)
    assert [(o.config, o.value) for o in ours.history] \
        == [(o.config, o.value) for o in ref.history]
    assert ours.default_value == ref.default_value
    # a smaller space replaces the engine's
    small = knobs.KnobSpace([knobs.HEMEM_SPACE["read_hot_threshold"],
                             knobs.HEMEM_SPACE["migration_period"]])
    res = Study(_spec()).tune(budget=12, batch_size=4, n_init=4, space=small,
                              objective=lambda c: _objective(
                                  dict(knobs.HEMEM_SPACE.default_config(),
                                       **c)))
    assert all(set(o.config) == {k.name for k in small} for o in res.history)


def test_study_tune_model_rounds_score_on_the_spec_device(pinned_backend,
                                                         monkeypatch):
    """The spec's device reaches ``suggest_topq``: on the CPU the pool is
    scored by numpy, and pinning the torch path gives the same history."""
    devices = []
    orig = forest_fast.suggest_topq

    def spy(*args, **kwargs):
        devices.append(kwargs.get("device"))
        return orig(*args, **kwargs)

    monkeypatch.setattr(forest_fast, "suggest_topq", spy)
    kw = dict(budget=24, batch_size=4, seed=1, n_init=8, objective=_objective)
    forest_fast.BACKEND = None
    a = Study(_spec()).tune(**kw)
    forest_fast.BACKEND = "torch"
    b = Study(_spec()).tune(**kw)
    assert devices and set(devices) == {"cpu"}
    assert [o.config for o in a.history] == [o.config for o in b.history]


def test_study_constructor_and_workload_cache():
    spec = _spec()
    study = Study(spec)
    assert study.spec == spec
    with pytest.raises(TypeError):
        Study("hemem")
    wl = study.workload()
    assert study.workload() is wl
    other = WorkloadSpec("gapbs-pr", "kron", threads=8, scale=SCALE)
    assert study.workload(other) is study.workload(other)
    assert study.workload(other).name == "gapbs-pr"


def test_simulation_cells_seed_rules():
    study = Study(_spec("static"))
    wl = study.workload()
    cells = [(wl, "static", [{}, {}]), (wl, "oracle", [{}])]
    with pytest.raises(ValueError, match="per cell"):
        tsim.run_simulation_cells(cells, seeds=[1, 2, 3], device="cpu")
    with pytest.raises(ValueError, match="per cell"):
        tsim.run_simulation_cells(cells, seeds=[[1], [2]], device="cpu")
    assert tsim.run_simulation_cells([], device="cpu") == []
    assert tsim.run_simulation_cells([(wl, "static", [])],
                                     device="cpu") == [[]]
    # CRN collapses each cell to its first seed
    hemem = [(wl, "hemem", [EngineSpec("hemem").config] * 2)]
    crn = tsim.run_simulation_cells(hemem, seeds=[[4, 9]], crn=True,
                                    device="cpu")[0]
    same = tsim.run_simulation_cells(hemem, seeds=[[4, 4]], crn=True,
                                     device="cpu")[0]
    for a, b in zip(crn, same):
        assert np.array_equal(a.epoch_wall_ms, b.epoch_wall_ms)
    assert np.array_equal(crn[0].epoch_wall_ms, crn[1].epoch_wall_ms)


def _assert_cells_close(engine, ours, ref):
    for a, b in zip(ours, ref):
        assert a.epoch_wall_ms.shape == b.epoch_wall_ms.shape
        if engine in ("static", "oracle"):
            assert np.array_equal(a.cum_migrations, b.cum_migrations)
            np.testing.assert_allclose(a.epoch_wall_ms, b.epoch_wall_ms,
                                       rtol=WALL_RTOL, atol=0)
        else:
            mig = abs(a.cum_migrations[-1] - b.cum_migrations[-1])
            assert mig <= MIG_RTOL * max(b.cum_migrations[-1], 1.0)
            assert abs(a.total_s - b.total_s) <= TOTAL_RTOL * b.total_s


def test_sweep_matches_reference_and_own_runs():
    engines = ["static", "hemem", "oracle"]
    workloads = ["gups", WorkloadSpec("gapbs-pr", "kron", threads=8,
                                      scale=SCALE)]
    ref_workloads = ["gups", jax_specs.WorkloadSpec(
        "gapbs-pr", "kron", threads=8, scale=SCALE)]
    ours = Study(_spec()).sweep(engines=engines, workloads=workloads)
    ref = JaxStudy(_jax_spec()).sweep(engines=engines,
                                      workloads=ref_workloads)
    assert isinstance(ours, SweepResult)
    assert list(ours.cells) == list(ref.cells) and len(ours) == 6
    for key, results in ours.items():
        _assert_cells_close(key[0], results, ref[key])
        wspec = WorkloadSpec("gups", threads=8, scale=SCALE) \
            if key[1].startswith("gups") else workloads[1]
        own = Study(ExperimentSpec(engine=key[0], workload=wspec,
                                   options=_spec().options)).run(
            configs=[EngineSpec(key[0]).config])
        for a, b in zip(results, own):
            assert np.array_equal(a.epoch_wall_ms, b.epoch_wall_ms)
            assert np.array_equal(a.cum_migrations, b.cum_migrations)
    assert ours.total_s() == {k: [r.total_s for r in v]
                              for k, v in ours.items()}


def test_sweep_configs_grid_and_variant_labels():
    space = knobs.HEMEM_SPACE
    cfgs = [space.default_config(),
            dict(space.default_config(), read_hot_threshold=2,
                 migration_period=50)]
    study = Study(_spec())
    ours = study.sweep({"configs": cfgs})
    ref = JaxStudy(_jax_spec()).sweep({"configs": cfgs})
    assert list(ours.cells) == list(ref.cells)
    key = ("hemem", study.spec.workload.key)
    _assert_cells_close("hemem", ours[key], ref[key])
    own = study.run(configs=cfgs)
    for a, b in zip(ours[key], own):
        assert np.array_equal(a.epoch_wall_ms, b.epoch_wall_ms)
        assert np.array_equal(a.cum_migrations, b.cum_migrations)
    # same-name variants get the reference's labels
    variants = [WorkloadSpec("gups", "8GiB-hot", threads=t, scale=SCALE)
                for t in (4, 8)]
    ref_variants = [jax_specs.WorkloadSpec("gups", "8GiB-hot", threads=t,
                                           scale=SCALE) for t in (4, 8)]
    got = study.sweep(engines=["static"], workloads=variants)
    want = JaxStudy(_jax_spec()).sweep(engines=["static"],
                                       workloads=ref_variants)
    assert list(got.cells) == list(want.cells)
    with pytest.raises(ValueError, match="duplicate"):
        study.sweep(workloads=[variants[0], variants[0]])
