"""The port's TieredParamStore and its numpy HeMem engine against the
reference package, on the CPU.

The engine copy (``repro_torch.core.engine``) consumes the same
``np.random.default_rng`` streams as ``repro.core.engine``, so counts,
plans and placements are compared bitwise; so is a store's residency
trajectory.  The store's pool is bf16, as the reference's: rows compare
bitwise to the host rows cast to bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import pages as jpages  # noqa: E402
from repro.core.knobs import HEMEM_SPACE as JAX_HEMEM_SPACE  # noqa: E402
from repro.core.tiered_params import TieredParamStore as JaxStore  # noqa: E402
from repro_torch.core import engine, pages  # noqa: E402
from repro_torch.core import registry  # noqa: E402
from repro_torch.core.knobs import HEMEM_SPACE  # noqa: E402
from repro_torch.core.tiered_params import TieredParamStore  # noqa: E402

HOT_CONFIG = dict(read_hot_threshold=1, sampling_period=100)


def _bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().view(torch.int16).numpy()
    return np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.int16)


def route_stream(seed, steps, n_ids, E=32, n_hot=8, hot_mass=0.9):
    """Expert ids of ``steps`` batches: ``n_hot`` hot experts among
    12..E-1 carry ``hot_mass`` of the slots."""
    rng = np.random.default_rng(seed)
    hot = np.sort(rng.choice(np.arange(12, E), n_hot, replace=False))
    p = np.full(E, (1 - hot_mass) / (E - n_hot))
    p[hot] = hot_mass / n_hot
    return hot, [rng.choice(E, size=n_ids, p=p) for _ in range(steps)]


# ---------------------------------------------------------------------------
# the reference test's checks, on the port
# ---------------------------------------------------------------------------
def test_tiered_params_hot_experts_promoted():
    """``tests/test_tiered.py::test_tiered_params_hot_experts_promoted``."""
    rng = np.random.default_rng(3)
    weights = {"w": rng.normal(size=(16, 8, 8)).astype(np.float32)}
    store = TieredParamStore(weights, hbm_experts=4, config=HOT_CONFIG,
                             device="cpu")
    hot = np.array([12, 13, 14, 15])
    for _ in range(30):
        store.route(np.repeat(hot, 50))
        store.step_engine(100.0)
    assert set(np.flatnonzero(store.slot_of >= 0)) >= set(hot.tolist())
    g = store.gather("w", np.array([12, 0]))
    assert g.dtype == torch.bfloat16 and g.shape == (2, 8, 8)
    np.testing.assert_allclose(g[0].float().numpy(), weights["w"][12],
                               atol=2e-2)


def test_store_layout_and_first_touch():
    w = np.arange(6 * 3 * 2, dtype=np.float32).reshape(6, 3, 2)
    store = TieredParamStore({"a": w, "b": torch.from_numpy(w[:, :1])}, 4,
                             device="cpu")
    assert store.host["a"].dtype == torch.float32
    assert not store.host["a"].is_pinned()       # pinned only for a card
    assert store.hbm["a"].shape == (4, 3, 2)
    assert store.hbm["b"].dtype == torch.bfloat16
    assert store.bytes_per_expert == (6 + 2) * 4 == store.tier.page_bytes
    assert store.slot_of.tolist() == [0, 1, 2, 3, -1, -1]
    assert store.expert_of_slot.tolist() == [0, 1, 2, 3]
    assert store.tier.in_fast.tolist() == [True] * 4 + [False] * 2


def test_route_takes_tensors_and_counts_hits():
    w = np.ones((8, 2, 2), np.float32)
    store = TieredParamStore({"w": w}, 2, device="cpu")
    res = store.route(torch.tensor([[0, 1], [5, 0]]))
    assert res == {0: True, 1: True, 5: False}
    assert (store.fast_hits, store.slow_hits) == (3, 1)
    assert store.hit_rate() == 0.75
    assert store._counts.tolist() == [2, 1, 0, 0, 0, 1, 0, 0]


def test_gather_is_bitwise_the_host_rows_in_bf16():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 5, 3)).astype(np.float32)
    store = TieredParamStore({"w": w}, 3, device="cpu")
    ids = np.array([6, 0, 2, 7, 2, 1])
    got = store.gather("w", ids)
    want = torch.from_numpy(w[ids]).to(torch.bfloat16)
    assert np.array_equal(_bf16_bits(got), _bf16_bits(want))
    assert np.array_equal(_bf16_bits(got), _bf16_bits(
        JaxStore({"w": w}, 3).gather("w", ids)))


# ---------------------------------------------------------------------------
# the numpy copies against the reference, bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rate", [10.0, np.array([0.5, 3.0, 1e-4])])
def test_migration_rate_pages_matches(rate):
    for epoch_ms in (0.1, 100.0, 500.0):
        for page_bytes in (pages.PAGE_BYTES, 6_291_456, 17):
            got = pages.migration_rate_pages(rate, epoch_ms, page_bytes)
            want = jpages.migration_rate_pages(rate, epoch_ms, page_bytes)
            assert np.array_equal(got, want) and \
                np.asarray(got).dtype == np.asarray(want).dtype


def test_tier_state_matches_reference():
    rng = np.random.default_rng(4)
    a, b = pages.BatchTierState(3, 40, 12), jpages.BatchTierState(3, 40, 12)
    for epoch in range(6):
        touched = rng.uniform(size=40) < 0.3 if epoch % 2 else \
            rng.uniform(size=(3, 40)) < 0.2
        assert np.array_equal(a.allocate_first_touch(touched),
                              b.allocate_first_touch(touched))
        plans = []
        for row in range(3):
            fast = np.flatnonzero(a.in_fast[row])
            slow = np.flatnonzero(a.allocated[row] & ~a.in_fast[row])
            d = fast[: rng.integers(0, len(fast) + 1)]
            room = a.fast_capacity - len(fast) + len(d)
            p = slow[: min(room, rng.integers(0, len(slow) + 1))]
            plans.append((p, d))
        a.apply([pages.MigrationPlan(p, d) for p, d in plans])
        b.apply([jpages.MigrationPlan(p, d) for p, d in plans])
        for name in ("in_fast", "allocated", "total_promoted",
                     "total_demoted", "fast_free"):
            assert np.array_equal(getattr(a, name), getattr(b, name)), name
    t = pages.TierState(10, 3)
    assert t.allocate_first_touch(np.arange(10) < 5) == 5
    assert t.fast_used == 3 and t.fast_free == 0
    with pytest.raises(AssertionError):
        t.apply(pages.MigrationPlan(np.array([4]), np.zeros(0, np.int64)))
    assert pages.MigrationPlan.empty().n_pages == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hemem_engine_copy_is_bitwise_the_reference(seed):
    """Random configs and access counts over 12 epochs: counts, cooling,
    plans and placement after applying them, all bitwise."""
    rng = np.random.default_rng(seed)
    n, cap = 96, 24
    cfg = JAX_HEMEM_SPACE.sample(rng)
    assert HEMEM_SPACE.validate(dict(cfg)) == JAX_HEMEM_SPACE.validate(
        dict(cfg))
    cfg.update(read_hot_threshold=rng.integers(1, 4),
               migration_period=rng.choice([10, 100, 400]))
    tiers = [mod.TierState(n, cap, page_bytes=1 << 20)
             for mod in (pages, jpages)]
    engines = [engine.HeMemEngine(cfg, tiers[0], seed=seed),
               jengine.HeMemEngine(cfg, tiers[1], seed=seed)]
    for epoch in range(12):
        touched = np.arange(n) < 16 * (epoch + 1)
        hot = rng.uniform(size=n) < 0.2
        reads = np.where(hot, rng.integers(500, 5000, n),
                         rng.integers(0, 60, n)).astype(np.float64)
        writes = rng.integers(0, 40, n).astype(np.float64)
        plans = []
        for tier, eng in zip(tiers, engines):
            tier.allocate_first_touch(touched)
            eng.observe(reads * touched, writes * touched, 100.0)
            plans.append(eng.plan(100.0, max_pages_this_epoch=cap))
            tier.apply(plans[-1])
        (a, b), (pa, pb) = engines, plans
        assert np.array_equal(pa.promote, pb.promote)
        assert np.array_equal(pa.demote, pb.demote)
        assert np.array_equal(a.read_counts, b.read_counts)
        assert np.array_equal(a.write_counts, b.write_counts)
        assert np.array_equal(a.hot_mask(), b.hot_mask())
        assert a.cooling_events == b.cooling_events
        assert a.samples_last_epoch == b.samples_last_epoch
        assert np.array_equal(tiers[0].in_fast, tiers[1].in_fast)


def test_engine_copy_is_not_in_the_registry():
    """The compiled epoch loop owns the compiled table's names: the numpy
    engine the store drives is the name's numpy engine, never its
    compiled definition."""
    from repro_torch.core import engine_torch
    assert registry.COMPILED.get("hemem") is engine_torch.HeMemDef
    assert registry.COMPILED.get("hemem") is not engine.BatchHeMemEngine
    assert registry.ENGINES.get("hemem") is engine.BatchHeMemEngine
    assert registry.SAMPLERS.get("elementwise") is engine._elementwise_draw


# ---------------------------------------------------------------------------
# a store's trajectory against the reference store
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,hbm,config", [
    (0, 8, HOT_CONFIG),
    (1, 4, dict(HOT_CONFIG, cooling_threshold=2, hot_ring_reqs_threshold=3)),
    (2, 8, {}),
])
def test_store_trajectory_is_bitwise_the_reference(seed, hbm, config):
    """30 steps of route + step_engine on a skewed stream: residency,
    migrations and hits after every step, and gather, bitwise."""
    rng = np.random.default_rng(seed)
    w = {"w_gate": rng.normal(size=(32, 16, 8)).astype(np.float32),
         "w_down": rng.normal(size=(32, 8, 16)).astype(np.float32)}
    port = TieredParamStore(w, hbm, config=config, seed=seed, device="cpu")
    ref = JaxStore(w, hbm, config=config, seed=seed)
    hot, stream = route_stream(seed, 30, 4096)
    for ids in stream:
        assert port.route(torch.from_numpy(ids)) == ref.route(ids)
        port.step_engine(100.0)
        ref.step_engine(100.0)
        assert np.array_equal(port.slot_of, ref.slot_of)
        assert np.array_equal(port.expert_of_slot, ref.expert_of_slot)
        assert (port.migrations, port.fast_hits, port.slow_hits) == \
            (ref.migrations, ref.fast_hits, ref.slow_hits)
    if config is HOT_CONFIG:   # the reference test's config: hot set resident
        assert set(hot.tolist()) <= set(np.flatnonzero(port.slot_of >= 0))
    assert port.migrations > 0
    ids = np.concatenate([hot[:4], np.flatnonzero(port.slot_of < 0)[:4]])
    for name in w:
        assert np.array_equal(_bf16_bits(port.gather(name, ids)),
                              _bf16_bits(ref.gather(name, ids)))
        assert np.array_equal(_bf16_bits(port.hbm[name]),
                              _bf16_bits(ref.hbm[name]))
