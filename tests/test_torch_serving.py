"""The port's tiered-KV serving path against the JAX reference, on the CPU.

At the small ``SPEC`` and the ``CORNERS`` configs of ``tests/test_serving.py``
(3 sequences x 4 pages, 5 HBM pages, 60 steps, an engine epoch every 5):

* the fused (``compiled=True``) cache of the port against the reference's
  compiled cache: at every engine epoch the HBM residency sets and the
  migration counts are bitwise equal, decode outputs agree within the bf16
  tolerance (1e-2), recall within 1e-6 (its float sums run in another
  order).  Integer access counts make the engine inputs bitwise equal,
  and the kv-hemem engine's float arithmetic (mean draws, cooling,
  thresholds) gives the same bits here;
* the port's two modes (fused and per-page reference loop) against each
  other: bitwise, as they call one decision function;
* the state bridge: a reference run handed over mid-run resumes in the port
  (and a port run in the reference) with bitwise equal residency,
  migrations and pool rows;
* traffic: ``step_read_counts`` (numpy and torch), ``arrival_trace``,
  ``replay_schedule`` and the ``kv-*`` workload traces are bitwise equal;
* simulator: ``Study.run`` of kv-hemem on kv-poisson against the
  reference's ``backend="jax"`` within the sampled-engine tolerances of
  ``tests/test_torch_engine.py``;
* tuning: ``Study.tune(objective=...)`` with a deterministic toy
  objective gives the reference's history config for config.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import ExperimentSpec as JaxExperimentSpec  # noqa: E402
from repro.core import SimOptions as JaxSimOptions  # noqa: E402
from repro.core import Study as JaxStudy  # noqa: E402
from repro.core import traffic as jtraffic  # noqa: E402
from repro.core.tiered_kv import KVSpec as JaxKVSpec  # noqa: E402
from repro.core.tiered_kv import TieredKVCache as JaxCache  # noqa: E402
from repro.core.workloads import make_workload as jax_make_workload  # noqa: E402
from repro_torch.core import ExperimentSpec, SimOptions, Study  # noqa: E402
from repro_torch.core import traffic  # noqa: E402
from repro_torch.core.serving_torch import state_to_host  # noqa: E402
from repro_torch.core.tiered_kv import KV_MODELS, KVSpec, TieredKVCache  # noqa: E402
from repro_torch.core.workloads import make_workload  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving_replay import replay, serving_objective  # noqa: E402

SPEC = KVSpec(n_layers=1, kv_heads=2, head_dim=8, page_tokens=8)
JAX_SPEC = JaxKVSpec(n_layers=1, kv_heads=2, head_dim=8, page_tokens=8)
GEOMETRY = dict(batch=3, max_pages_per_seq=4, hbm_pages=5)

#: the corner configs of tests/test_serving.py
CORNERS = [
    None,
    dict(read_hot_threshold=1, sampling_period=100, migration_period=10),
    dict(read_hot_threshold=24, cooling_threshold=40,
         migration_period=2000, sampling_period=8000),
    dict(read_hot_threshold=2, write_hot_threshold=1, cooling_threshold=4,
         cooling_pages=1024, migration_period=10),
]
OUT_TOL = 1e-2     # one bf16 rounding of an output
RECALL_TOL = 1e-6


def _inputs(B, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(B, 1, 2, 8)).astype(np.float32)
    q = rng.normal(size=(B, 2, 8)).astype(np.float32)
    return k, q


def _f32(out):
    if isinstance(out, torch.Tensor):
        return out.to(torch.float32).numpy()
    return np.asarray(out, np.float32)


def _drive(cache, steps, *, start=0, engine_every=5, seed=0):
    """The decode loop of tests/test_serving.py (a sequence finishes after
    16 + 3*b tokens); returns per-epoch (slot_of, migrations) snapshots and
    every step's output.  ``start`` continues the step count of a run
    handed over mid-way."""
    k, q = _inputs(cache.batch, seed)
    limit = 16 + 3 * np.arange(cache.batch)
    snaps, outs = [], []
    for t in range(start, start + steps):
        outs.append(_f32(cache.decode_step(k, k, q)))
        if t % engine_every == engine_every - 1:
            cache.step_engine(50.0)
            snaps.append((np.asarray(cache.slot_of).copy(), cache.migrations))
        done = cache.lengths >= limit
        if done.any():
            cache.reset_seqs(done)
    return snaps, outs


def _assert_same_residency(a, b):
    assert len(a) == len(b)
    for e, ((slot_a, mig_a), (slot_b, mig_b)) in enumerate(zip(a, b)):
        assert mig_a == mig_b, f"epoch {e}: migration counts diverge"
        np.testing.assert_array_equal(
            slot_a >= 0, slot_b >= 0,
            err_msg=f"epoch {e}: HBM residency sets diverge")


def _port(config, compiled=True):
    return TieredKVCache(SPEC, config=config, compiled=compiled,
                         device="cpu", **GEOMETRY)


def _jax(config):
    return JaxCache(JAX_SPEC, config=config, compiled=True, **GEOMETRY)


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("config", CORNERS)
def test_compiled_matches_reference_package(config):
    ours, ref = _port(config), _jax(config)
    so, oo = _drive(ours, 60)
    sr, orf = _drive(ref, 60)
    assert len(so) == 12
    _assert_same_residency(so, sr)
    for a, b in zip(oo, orf):
        np.testing.assert_allclose(a, b, atol=OUT_TOL, rtol=OUT_TOL)
    assert abs(ours.recall() - ref.recall()) <= RECALL_TOL
    if config is None or config.get("migration_period", 10) <= 10:
        assert so[-1][1] > 0, "sweep produced no migrations (test too weak)"


@pytest.mark.parametrize("config", CORNERS)
def test_fused_and_reference_loop_agree_bitwise(config):
    fused, loop = _port(config, True), _port(config, False)
    sf, of = _drive(fused, 60)
    sl, ol = _drive(loop, 60)
    for (slot_f, mig_f), (slot_l, mig_l) in zip(sf, sl):
        assert mig_f == mig_l
        np.testing.assert_array_equal(slot_f, slot_l)
    for a, b in zip(of, ol):
        np.testing.assert_array_equal(a, b)
    assert fused.recall() == pytest.approx(loop.recall(), abs=RECALL_TOL)


def _jax_host_state(cache):
    st = cache._st
    host = {k: np.asarray(v) for k, v in st.items() if k != "eng"}
    host["eng"] = {k: np.asarray(v) for k, v in st["eng"].items()}
    return host


def _same_state(ours, theirs):
    """Every state entry equal, pools bit for bit, dump rows excluded (their
    contents depend on the order of duplicate writes)."""
    assert set(ours) == set(theirs)
    for key, a in ours.items():
        b = theirs[key]
        if key == "eng":
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            continue
        b = np.asarray(b)
        if key in ("hbm_k", "hbm_v", "host_k", "host_v"):
            a, b = a[:-1], b[:-1].view(np.uint16)
        elif key in ("slot_of", "page_of_slot"):
            a, b = a[:-1], b[:-1]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if key.startswith("recall"):
            assert abs(float(a) - float(b)) <= RECALL_TOL * max(1, float(b))
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


def test_state_after_a_run_equals_reference_state():
    """Pins the append's advanced indexing (``pool[rows, :, off] = kt``
    puts the (B,) index dimension first) and every other state entry."""
    config = CORNERS[1]
    ours, ref = _port(config), _jax(config)
    _drive(ours, 37)
    _drive(ref, 37)
    _same_state(state_to_host(ours._st), _jax_host_state(ref))


@pytest.mark.parametrize("config", [None, CORNERS[3]])
def test_bridge_resumes_reference_run_in_port(config):
    ref, handed = _jax(config), _port(config)
    _drive(ref, 28)
    handed.load_state(_jax_host_state(ref))
    s_ref, o_ref = _drive(ref, 32, start=28)
    s_port, o_port = _drive(handed, 32, start=28)
    _assert_same_residency(s_port, s_ref)
    for a, b in zip(o_port, o_ref):
        np.testing.assert_allclose(a, b, atol=OUT_TOL, rtol=OUT_TOL)
    _same_state(handed.host_state(), _jax_host_state(ref))


def test_bridge_resumes_port_run_in_reference():
    config = CORNERS[1]
    ours, ref = _port(config), _jax(config)
    _drive(ours, 28)
    host = ours.host_state()
    st = {k: jnp.asarray(v.view(jnp.bfloat16) if v.dtype == np.uint16 else v)
          for k, v in host.items() if k != "eng"}
    st["eng"] = {k: jnp.asarray(v) for k, v in host["eng"].items()}
    ref._st = st
    s_port, _ = _drive(ours, 32, start=28)
    s_ref, _ = _drive(ref, 32, start=28)
    _assert_same_residency(s_port, s_ref)


def test_compiled_cache_api_edges():
    cache = _port(None)
    with pytest.raises(RuntimeError, match="fuses read recording"):
        cache.record_reads()
    with pytest.raises(RuntimeError, match="reference-mode only"):
        cache.set_mass_fn(lambda: None)
    with pytest.raises(RuntimeError, match="compiled=True"):
        _port(None, compiled=False).host_state()
    k, q = _inputs(3)
    cache.decode_step(k, k, q)
    res, tot = cache.last_step_pages
    assert res.shape == tot.shape == (3,) and (res <= tot).all()
    assert 0.0 <= cache.hbm_utilization() <= 1.0


def test_chatglm3_widths_are_the_reference_config():
    from repro.configs.chatglm3_6b import CONFIG
    m = KV_MODELS["chatglm3-6b"]
    assert (m.spec.n_layers, m.spec.kv_heads, m.spec.head_dim, m.q_heads) \
        == (CONFIG.n_layers, CONFIG.n_kv_heads, CONFIG.head_dim,
            CONFIG.n_heads)
    assert m.spec.dtype == torch.bfloat16 and m.spec.page_tokens == 64
    assert m.source == "src/repro/configs/chatglm3_6b.py"


# ---------------------------------------------------------------------------
# replay and the serving objective
# ---------------------------------------------------------------------------
def test_replay_modes_agree_and_count_launch_sites():
    tr = traffic.TrafficSpec(pattern="bursty-diurnal", arrival_rate=8 / 24,
                             steps=96)
    fused = replay(None, tr, batch=8, max_pages=8, device="cpu",
                   record=True)
    loop = replay(None, tr, batch=8, max_pages=8, device="cpu",
                  compiled=False, record=True)
    assert fused["migrations"] == loop["migrations"] > 0
    np.testing.assert_array_equal(fused["epoch_slots"], loop["epoch_slots"])
    assert torch.equal(fused["outputs"], loop["outputs"])
    assert serving_objective(fused) == serving_objective(loop)
    assert fused["p99_ms"] >= fused["p50_ms"] > 0 and fused["tokens"] > 0


# ---------------------------------------------------------------------------
# traffic and the kv-* workloads
# ---------------------------------------------------------------------------
def test_step_read_counts_bitwise_across_packages():
    lengths = np.array([0, 1, 7, 8, 9, 64, 2047, 2048], np.int32)
    scale = 64 * 2 * 28 * 64
    c_ref, a_ref = jtraffic.step_read_counts(lengths, 32, 64, scale, xp=np)
    c_np, a_np = traffic.step_read_counts(lengths, 32, 64, scale, xp=np)
    c_t, a_t = traffic.step_read_counts(torch.from_numpy(lengths), 32, 64,
                                        scale, xp=torch)
    c_j, a_j = jax.jit(lambda ln: jtraffic.step_read_counts(
        ln, 32, 64, scale, xp=jnp))(jnp.asarray(lengths))
    for c, a in ((c_np, a_np), (c_t.numpy(), a_t.numpy()),
                 (np.asarray(c_j), np.asarray(a_j))):
        assert c.dtype == np.int32
        np.testing.assert_array_equal(c, c_ref)
        np.testing.assert_array_equal(a, a_ref)


@pytest.mark.parametrize("pattern", ["poisson", "bursty-diurnal"])
def test_arrival_trace_and_schedule_bitwise(pattern):
    kw = dict(pattern=pattern, arrival_rate=3.0, steps=96, decode_lo=8,
              decode_hi=40)
    ours, theirs = traffic.TrafficSpec(**kw), jtraffic.TrafficSpec(**kw)
    assert ours.to_json() == theirs.to_json()
    for a, b in zip(traffic.arrival_trace(ours, 7),
                    jtraffic.arrival_trace(theirs, 7)):
        np.testing.assert_array_equal(a, b)
    so = traffic.replay_schedule(ours, 6, 32, 3)
    sr = jtraffic.replay_schedule(theirs, 6, 32, 3)
    assert set(so) == set(sr)
    for key in so:
        np.testing.assert_array_equal(so[key], sr[key])
    with pytest.raises(ValueError, match="unknown traffic pattern"):
        traffic.TrafficSpec(pattern="sawtooth")
    with pytest.raises(KeyError, match="did you mean"):
        traffic.TrafficSpec.from_json({"arival_rate": 1.0})


@pytest.mark.parametrize("name", ["kv-poisson", "kv-diurnal"])
def test_kv_workload_traces_bitwise(name):
    ours = make_workload(name, scale=1.0, seed=2)
    theirs = jax_make_workload(name, scale=1.0, seed=2)
    assert (ours.n_pages, ours.n_epochs) == (theirs.n_pages, theirs.n_epochs)
    for e in (0, 5, theirs.n_epochs - 1):
        for a, b in zip(ours.epoch_access(e), theirs.epoch_access(e)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# simulator and tuning
# ---------------------------------------------------------------------------
def test_study_run_kv_hemem_matches_reference():
    ours = Study(ExperimentSpec(
        engine="kv-hemem", workload="kv-poisson",
        options=SimOptions(device="cpu"))).run()
    ref = JaxStudy(JaxExperimentSpec(
        engine="kv-hemem", workload="kv-poisson",
        options=JaxSimOptions(backend="jax"))).run()
    assert ours.epoch_wall_ms.shape == ref.epoch_wall_ms.shape
    mig_rel = abs(ours.cum_migrations[-1] - ref.cum_migrations[-1]) \
        / max(ref.cum_migrations[-1], 1.0)
    assert mig_rel <= 0.01
    assert abs(ours.total_s - ref.total_s) <= 1e-3 * ref.total_s


def _toy_objective(config):
    """Deterministic, cheap and config-sensitive."""
    return (np.log(config["sampling_period"])
            + abs(config["read_hot_threshold"] - 6) * 0.25
            + config["migration_period"] / 1000.0
            + np.log1p(config["cooling_threshold"]) * 0.1)


@pytest.mark.parametrize("batch_size", [1, 3])
def test_tune_with_custom_objective_matches_reference(batch_size):
    kw = dict(budget=9, batch_size=batch_size, seed=1, n_init=4,
              objective=_toy_objective)
    ours = Study(ExperimentSpec(engine="kv-hemem", workload="kv-poisson",
                                options=SimOptions(device="cpu"))).tune(**kw)
    ref = JaxStudy(JaxExperimentSpec(engine="kv-hemem",
                                     workload="kv-poisson")).tune(**kw)
    assert [o.config for o in ours.history] == \
        [o.config for o in ref.history]
    assert [o.value for o in ours.history] == [o.value for o in ref.history]
    assert ours.default_value == ref.default_value


def test_tune_objective_batch_is_used_for_rounds():
    seen = []

    def batch_objective(configs):
        seen.append(len(configs))
        return [_toy_objective(c) for c in configs]

    res = Study(ExperimentSpec(engine="kv-hemem", workload="kv-poisson",
                               options=SimOptions(device="cpu"))).tune(
        budget=6, batch_size=3, n_init=4, objective=_toy_objective,
        objective_batch=batch_objective)
    assert len(res.history) == 6 and seen == [1, 3, 3]


def test_serving_launches_nothing_on_the_cpu():
    ops.reset_launch_counts()
    cache = _port(CORNERS[1])
    _drive(cache, 20)
    assert ops.launch_counts() == {"select_topk": 0, "page_migrate": 0,
                                   "paged_attention": 0,
                                   "flash_attention": 0}
