"""The port's legacy BO pieces, knob helpers and registry API against the
reference's, on the CPU.

* ``RandomForest(mode="reference")`` (the recursive CART grower) emits
  flat arrays bitwise those of the port's fast grower and of the
  reference's reference grower;
* after a fixed history of tells, ten ``SMACOptimizer(acquisition=
  "legacy")`` asks (q = 1 and 4, both growers) equal the reference's;
  ``Study.tune(surrogate="reference", acquisition="legacy")`` on the
  numpy backend equals the reference's study, history for history;
* the legacy EI pieces, the knob helpers (``names``, ``sample_batch``,
  ``decode``, ``encode_batch``, ``validate_batch``, ``neighbors``) and the
  registry's dictionary API and backends match the reference's.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core as R  # noqa: E402
from repro.core import registry as ref_registry  # noqa: E402
from repro.core.bo import rf as ref_rf  # noqa: E402
from repro.core.bo import smac as ref_smac  # noqa: E402
from repro.core.knobs import get_space as ref_space  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import registry  # noqa: E402
from repro_torch.core.bo import rf, smac  # noqa: E402
from repro_torch.core.knobs import get_space  # noqa: E402

FLAT = ("feature", "threshold", "left", "right", "value", "n_nodes")


def _history(space, n, seed):
    rng = np.random.default_rng(seed)
    cfgs = [space.sample(rng) for _ in range(n)]
    vals = [float(np.sum((space.encode(c) - 0.3) ** 2)
                  + 0.05 * rng.standard_normal()) for c in cfgs]
    return cfgs, vals


@pytest.mark.parametrize("engine,n,seed", [("hemem", 12, 0),
                                           ("hemem", 60, 1),
                                           ("hmsdk", 30, 2)])
def test_reference_grower_is_bitwise_fast_and_reference(engine, n, seed):
    space = get_space(engine)
    cfgs, vals = _history(space, n, seed)
    X = np.stack([space.encode(c) for c in cfgs])
    y = np.array(vals)
    ours_ref = rf.RandomForest(seed=seed, mode="reference").fit(X, y)
    ours_fast = rf.RandomForest(seed=seed).fit(X, y)
    theirs = ref_rf.RandomForest(seed=seed, mode="reference").fit(X, y)
    assert len(ours_ref.trees) == ours_ref.n_trees and not ours_fast.trees
    for name in FLAT:
        a = getattr(ours_ref.forest, name)
        np.testing.assert_array_equal(a, getattr(ours_fast.forest, name))
        np.testing.assert_array_equal(a, getattr(theirs.forest, name))
    # the per-row walk of each reference tree equals the flat descent
    Xq = np.random.default_rng(9).uniform(size=(40, X.shape[1]))
    flat = np.stack([t.predict(Xq) for t in ours_ref.trees])
    mean, std = ours_ref._moments(flat)
    m2, s2 = ours_fast.predict(Xq)
    np.testing.assert_array_equal(mean, m2)
    np.testing.assert_array_equal(std, s2)
    assert rf.resolve_mode() == rf.DEFAULT_MODE == "fast"
    with pytest.raises(ValueError, match="surrogate mode"):
        rf.resolve_mode("exact")


@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("surrogate", ["reference", "fast"])
def test_legacy_asks_equal_the_reference(q, surrogate):
    space = get_space("hemem")
    cfgs, vals = _history(space, 25, 3)
    ours = smac.SMACOptimizer(space, seed=4, n_init=5, acquisition="legacy",
                              surrogate=surrogate, device="cpu")
    theirs = ref_smac.SMACOptimizer(ref_space("hemem"), seed=4, n_init=5,
                                    acquisition="legacy",
                                    surrogate=surrogate)
    for c, v in zip(cfgs, vals):
        ours.tell(c, v)
        theirs.tell(c, v)
    for _ in range(10):
        a, b = ours.ask_batch(q), theirs.ask_batch(q)
        assert a == b
        vv = [float(np.sum(space.encode(c))) for c in a]
        ours.tell_batch(a, vv)
        theirs.tell_batch(b, vv)


def test_study_tune_legacy_equals_the_reference():
    def spec(pkg, **opts):
        return pkg.ExperimentSpec(
            engine="hemem",
            workload=pkg.WorkloadSpec("gups", threads=8, scale=0.02),
            options=pkg.SimOptions(seed=2, **opts))
    kw = dict(budget=8, batch_size=2, seed=5, n_init=3,
              surrogate="reference", acquisition="legacy")
    ours = P.Study(spec(P, backend="numpy", device="cpu")).tune(**kw)
    theirs = R.Study(spec(R)).tune(**kw)
    assert [(o.config, o.value) for o in ours.history] == \
        [(o.config, o.value) for o in theirs.history]
    assert ours.default_value == theirs.default_value


def test_optimizer_refuses_unknown_modes():
    space = get_space("hemem")
    with pytest.raises(ValueError, match="acquisition"):
        smac.SMACOptimizer(space, acquisition="fast")
    with pytest.raises(ValueError, match="surrogate mode"):
        smac.SMACOptimizer(space, surrogate="exact")


def test_legacy_ei_pieces_equal_the_reference():
    rng = np.random.default_rng(0)
    z = rng.normal(0.0, 3.0, 500)
    mean = rng.normal(10.0, 2.0, 500)
    std = np.abs(rng.normal(0.0, 1.0, 500))
    np.testing.assert_array_equal(smac._norm_cdf_ref(z),
                                  ref_smac._norm_cdf_ref(z))
    np.testing.assert_array_equal(
        smac.expected_improvement_ref(mean, std, 9.0),
        ref_smac.expected_improvement_ref(mean, std, 9.0))
    np.testing.assert_array_equal(
        smac.expected_improvement(mean, std, 9.0),
        ref_smac.expected_improvement(mean, std, 9.0))
    np.testing.assert_allclose(smac._norm_cdf(z), smac._norm_cdf_ref(z),
                               atol=1e-6)


@pytest.mark.parametrize("helper", ["names", "sample_batch", "decode",
                                    "encode_batch", "validate_batch",
                                    "neighbors"])
@pytest.mark.parametrize("engine", ["hemem", "hmsdk", "memtis"])
def test_knob_helpers_equal_the_reference(helper, engine):
    ours, theirs = get_space(engine), ref_space(engine)
    rng = np.random.default_rng(7)
    cfgs = [theirs.sample(rng) for _ in range(6)]
    if helper == "names":
        assert ours.names == theirs.names
        return
    if helper == "sample_batch":
        a = ours.sample_batch(np.random.default_rng(1), 8)
        b = theirs.sample_batch(np.random.default_rng(1), 8)
    elif helper == "decode":
        u = np.random.default_rng(2).uniform(size=(5, len(theirs.knobs)))
        a = [ours.decode(x) for x in u]
        b = [theirs.decode(x) for x in u]
    elif helper == "encode_batch":
        np.testing.assert_array_equal(ours.encode_batch(cfgs),
                                      theirs.encode_batch(cfgs))
        assert ours.encode_batch([]).shape == (0, len(ours.knobs))
        return
    elif helper == "validate_batch":
        wild = [dict(c, **{k.name: 1e12}) for c, k in
                zip(cfgs, theirs.knobs)]
        a, b = ours.validate_batch(wild), theirs.validate_batch(wild)
    else:
        a = ours.neighbors(cfgs[0], np.random.default_rng(3), n=10,
                           scale=0.2)
        b = theirs.neighbors(cfgs[0], np.random.default_rng(3), n=10,
                             scale=0.2)
    assert a == b


def test_registry_dictionary_api_equals_the_reference():
    # the builtins (other test files in this process may register more)
    builtins = {"ENGINES": {"hemem", "hmsdk", "memtis", "static", "oracle",
                            "kv-hemem"},
                "SAMPLERS": {"elementwise", "sparse"},
                "MACHINES": {"pmem-large", "pmem-small", "numa",
                             "tpu-v5e-host"}}
    for name, want in builtins.items():
        ours, theirs = getattr(registry, name), getattr(ref_registry, name)
        assert want <= set(ours.keys()) and want <= set(theirs.keys())
        assert ours.keys() == sorted(ours.keys()) == list(ours)
        assert [k for k, _ in ours.items()] == ours.names()
        assert len(ours.values()) == len(ours)
        for k in want:
            assert type(ours[k]).__name__ == type(theirs[k]).__name__
    assert registry.BACKENDS.names() == ["numpy", "torch"]
    assert repr(registry.BACKENDS) == "Registry('backend', ['numpy', 'torch'])"
    assert P.BACKENDS is registry.BACKENDS
    assert P.register_backend is registry.register_backend
    for reg in (registry.Registry("thing"), ref_registry.Registry("thing")):
        reg["a"] = 1
        reg["a"] = 2          # __setitem__ overwrites
        reg.register("b", 3)
        assert reg["a"] == 2 and list(reg) == ["a", "b"] and len(reg) == 2
        with pytest.raises(ValueError, match="already registered"):
            reg.register("b", 4)
        reg.unregister("b")
        assert "b" not in reg and reg.items() == [("a", 2)]
        with pytest.raises(KeyError, match="did you mean 'a'"):
            reg.unregister("aa")
        assert repr(reg) == "Registry('thing', ['a'])"


def test_registered_backend_runs_the_numpy_loop():
    from repro_torch.core import simulator
    from repro_torch.core.workloads import make_workload
    calls = []

    def factory():
        inner = simulator._numpy_cost_fn()

        def cost(*args):
            calls.append(1)
            return inner(*args)
        return cost

    registry.register_backend("counting-numpy", factory)
    try:
        wl = make_workload("gups", "", threads=8, scale=0.02, seed=0)
        a = simulator.run_simulation_batch(wl, "static", [{}],
                                           backend="counting-numpy")[0]
        b = simulator.run_simulation_batch(wl, "static", [{}],
                                           backend="numpy")[0]
        assert len(calls) == wl.n_epochs
        np.testing.assert_array_equal(a.epoch_wall_ms, b.epoch_wall_ms)
        opts = P.SimOptions(backend="counting-numpy")
        assert opts.backend == "counting-numpy"
    finally:
        registry.BACKENDS.unregister("counting-numpy")
    with pytest.raises(KeyError, match="backend"):
        P.SimOptions(backend="counting-numpy")
