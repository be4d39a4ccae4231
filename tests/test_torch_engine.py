"""The PyTorch port's epoch loop against the JAX reference, on the CPU.

Same inputs — workload trace, configs, seeds — go through
``repro.core.engine_jax.run_epochs`` and
``repro_torch.core.engine_torch.run_epochs`` at one small shape (gups at
scale 0.02, 655 pages, 60 epochs, B = 4).

Tolerances, and why they are not bitwise:

* ``torch.exp`` and XLA's ``exp`` differ by one ulp on some inputs, which
  can move an inverse-CDF Poisson count by one (about one draw in a
  million), and the cost model's float row sums run in another order.
  ``acc_s = acc_sum - acc_f`` cancels when the fast tier serves most
  accesses, so one ulp of the f32 row sum (6e-8) becomes up to ~2e-6 of an
  epoch wall (measured 1.7e-6 for oracle, 2.1e-6 for memtis at this shape).
* static and oracle draw no monitoring noise: their migrations must be
  bitwise equal, their per-epoch walls within 1e-5 relative.
* hemem, memtis and hmsdk: one different count can change a migration
  decision, so final ``cum_migrations`` are held within 1% and ``total_s``
  within 1e-3 relative.
* Inside the port (segmented vs whole, CRN rows) results are bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine_jax  # noqa: E402
from repro.core.knobs import get_space  # noqa: E402
from repro.core.simulator import (_epoch_consts as jax_consts,  # noqa: E402
                                  get_machine, scale_config)
from repro.core.workloads import make_workload  # noqa: E402
from repro_torch.core import engine_torch, simulator as tsim  # noqa: E402
from repro_torch.core.pages import PAGE_BYTES  # noqa: E402
from repro_torch.core.workloads import make_workload as t_make_workload  # noqa: E402

ENGINES = ("hemem", "hmsdk", "memtis", "static", "oracle")
SAMPLED = ("hemem", "hmsdk", "memtis")
SCALE, B, SEED = 0.02, 4, 7
WALL_RTOL = 1e-5        # deterministic engines, per epoch
TOTAL_RTOL = 1e-3       # sampled engines, total_s
MIG_RTOL = 0.01         # sampled engines, final cum_migrations


def _workload():
    return make_workload("gups", "8GiB-hot", threads=8, scale=SCALE, seed=3)


def _configs(engine):
    if engine in SAMPLED:
        space = get_space(engine)
        rng = np.random.default_rng(5)
        cfgs = [space.default_config()] + [space.sample(rng)
                                           for _ in range(B - 1)]
    else:
        cfgs = [{} for _ in range(B)]
    return [scale_config(engine, c, SCALE) for c in cfgs]


def _args(engine):
    wl = _workload()
    const = jax_consts(wl, engine, get_machine("pmem-large"), PAGE_BYTES)
    fast_cap = max(1, int(round(wl.n_pages / 9.0)))
    return wl, engine, _configs(engine), const, fast_cap, PAGE_BYTES, \
        [SEED] * B


def _jax_run(engine, sampler, crn, **kw):
    return engine_jax.run_epochs(*_args(engine), sampler, crn=crn, **kw)


def _torch_run(engine, sampler, crn, **kw):
    return engine_torch.run_epochs(*_args(engine), sampler, crn=crn,
                                   device="cpu", **kw)


def _assert_close_to_reference(engine, ref, got, epochs=slice(None)):
    """The tolerances of the module docstring, on (E, B) result arrays."""
    ref_mig = ref["cum_migrations"][epochs]
    ref_wall = ref["wall_ms"][epochs].astype(np.float64)
    wall = got["wall_ms"].astype(np.float64)
    assert np.isfinite(wall).all() and wall.shape == ref_wall.shape
    if engine in SAMPLED:
        rel = np.abs(got["cum_migrations"][-1] - ref_mig[-1]) \
            / np.maximum(ref_mig[-1], 1.0)
        assert rel.max() <= MIG_RTOL, rel
        tot_rel = np.abs(wall.sum(0) - ref_wall.sum(0)) / ref_wall.sum(0)
        assert tot_rel.max() <= TOTAL_RTOL, tot_rel
    else:
        np.testing.assert_array_equal(got["cum_migrations"], ref_mig)
        np.testing.assert_allclose(wall, ref_wall, rtol=WALL_RTOL, atol=0)


CASES = [(e, s, True) for e in ENGINES for s in ("elementwise", "sparse")] \
    + [("hemem", "elementwise", False)]


@pytest.mark.parametrize("engine,sampler,crn", CASES)
def test_run_epochs_matches_reference(engine, sampler, crn):
    ref = _jax_run(engine, sampler, crn)
    got = _torch_run(engine, sampler, crn)
    _assert_close_to_reference(engine, ref, got)
    if crn and engine in ("static", "oracle"):
        # identical (empty) configs under CRN: every row is the same run
        for name in ("wall_ms", "cum_migrations"):
            assert (got[name] == got[name][:, :1]).all()


def test_monitor_draw_counts_match_reference():
    """Same keys, epoch, base and period: Poisson counts equal on at least
    99.99% of 786k draws, and every mismatch is off by exactly one (the
    one-ulp ``exp`` difference moving an inverse-CDF boundary)."""
    rng = np.random.default_rng(0)
    Bd, n = 6, 1 << 17
    keys = engine_jax.base_keys(list(range(Bd)), 0, False)
    base = np.concatenate([rng.uniform(0.0, 60.0, n // 2),
                           rng.exponential(2.0, n - n // 2)]) \
        .astype(np.float32)
    period = np.array([1.0, 2.0, 3.0, 7.0, 10.0, 0.5], np.float32)
    ref = np.asarray(engine_jax.monitor_draw(
        jnp.asarray(keys), jnp.int32(17), engine_jax._S_READ,
        jnp.asarray(base), jnp.asarray(period)))
    got = engine_torch.monitor_draw(
        torch.from_numpy(keys.astype(np.int64)), 17, engine_torch._S_READ,
        torch.from_numpy(base), torch.from_numpy(period)).numpy()
    diff = got - ref
    assert (diff == 0).mean() >= 0.9999
    assert set(np.unique(np.abs(diff))) <= {0.0, 1.0}


def test_kth_largest_matches_reference():
    rng = np.random.default_rng(2)
    v = np.concatenate([rng.integers(0, 5, (3, 500)),
                        rng.uniform(0, 1e3, (3, 500))], axis=1) \
        .astype(np.float32)
    for k in (0, 1, 77, 999):
        np.testing.assert_array_equal(
            engine_torch.kth_largest(torch.from_numpy(v), k).numpy(),
            np.asarray(engine_jax.kth_largest(jnp.asarray(v), k)))


@pytest.mark.parametrize("engine", ["hemem", "hmsdk"])
def test_segmented_run_bitwise_equal_to_whole_run(engine):
    whole = _torch_run(engine, "elementwise", True)
    first = _torch_run(engine, "elementwise", True, epoch_stop=23,
                       return_carry=True)
    rest = _torch_run(engine, "elementwise", True, epoch_start=23,
                      carry=first["carry"])
    for name in ("wall_ms", "cum_migrations", "hit_rate"):
        np.testing.assert_array_equal(
            np.concatenate([first[name], rest[name]]), whole[name])


@pytest.mark.parametrize("engine", ["hemem", "memtis", "oracle"])
def test_carry_bridge_resumes_across_frameworks(engine):
    """JAX runs [0, k), the port resumes [k, E) from JAX's host carry; and
    the port's host carry has exactly the reference's layout."""
    k = 31
    ref_whole = _jax_run(engine, "elementwise", True)
    ref_head = _jax_run(engine, "elementwise", True, epoch_stop=k,
                        return_carry=True)
    tail = _torch_run(engine, "elementwise", True, epoch_start=k,
                      carry=ref_head["carry"], return_carry=True)
    _assert_close_to_reference(engine, ref_whole, tail,
                               epochs=slice(k, None))
    # layout: same tree, shapes and dtypes as engine_jax.carry_to_host
    ours, theirs = tail["carry"], ref_head["carry"]
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours[:3] + ours[4:], theirs[:3] + theirs[4:]):
        assert a.dtype == b.dtype and a.shape == b.shape
    assert ours[3].keys() == theirs[3].keys()
    for name in ours[3]:
        assert ours[3][name].dtype == theirs[3][name].dtype
        assert ours[3][name].shape == theirs[3][name].shape
    np.testing.assert_array_equal(ours[5], theirs[5])  # row keys


def test_port_carry_resumes_in_reference():
    """The port runs [0, k), JAX resumes [k, E) from the port's carry."""
    k = 29
    ref_whole = _jax_run("hemem", "sparse", True)
    head = _torch_run("hemem", "sparse", True, epoch_stop=k,
                      return_carry=True)
    tail = engine_jax.run_epochs(*_args("hemem"), "sparse", crn=True,
                                 epoch_start=k, carry=head["carry"])
    _assert_close_to_reference("hemem", ref_whole, tail,
                               epochs=slice(k, None))


def test_crn_identical_configs_give_identical_rows():
    wl = t_make_workload("gups", "8GiB-hot", threads=8, scale=SCALE, seed=3)
    cfg = get_space("hemem").default_config()
    res = tsim.run_simulation_batch(wl, "hemem", [cfg] * 3, seeds=[4, 5, 6],
                                    crn=True, device="cpu")
    for r in res[1:]:
        np.testing.assert_array_equal(r.epoch_wall_ms, res[0].epoch_wall_ms)
        np.testing.assert_array_equal(r.cum_migrations,
                                      res[0].cum_migrations)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        engine_torch.run_epochs(*_args("static"), "sparse", device="cuda")


def test_run_epochs_past_the_old_page_ceiling():
    """gapbs-bc on kron at scale 1.7 (68,004 pages, past the 65,535 the
    selection kernel once took; the reference runs its numpy loop there):
    a few epochs of hemem complete on the CPU, CRN rows bitwise equal."""
    wl = t_make_workload("gapbs-bc", "kron", threads=12, scale=1.7, seed=0)
    assert wl.n_pages > 65_535
    sim = [tsim.scale_config("hemem", get_space("hemem").default_config(),
                             wl.scale)] * 2
    const = tsim._epoch_consts(wl, "hemem", tsim.get_machine("pmem-large"),
                               PAGE_BYTES)
    out = engine_torch.run_epochs(wl, "hemem", sim, const, wl.n_pages // 9,
                                  PAGE_BYTES, [0, 0], "elementwise",
                                  crn=True, epoch_stop=4, device="cpu")
    assert out["wall_ms"].shape == (4, 2)
    assert np.isfinite(out["wall_ms"]).all()
    assert out["cum_migrations"][-1, 0] > 0
    np.testing.assert_array_equal(out["wall_ms"][:, 0], out["wall_ms"][:, 1])
    # past the new ceiling the loop refuses, as it did past the old one
    huge = t_make_workload("gapbs-bc", "kron", threads=12, scale=12.0,
                           seed=0)
    assert huge.n_pages > engine_torch.MAX_PAGES
    with pytest.raises(ValueError, match="at most"):
        engine_torch.run_epochs(huge, "hemem", sim, const, 8, PAGE_BYTES,
                                [0, 0], "elementwise", device="cpu")
