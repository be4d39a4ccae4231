"""The PyTorch port's exact top-k selection and counter hashes against the
JAX reference.

* The port imports neither ``jax`` nor anything of ``repro`` (checked in a
  fresh interpreter).
* The port's hash words, base keys and uniforms are bitwise equal to
  ``repro.core.engine_jax``'s.
* The plain PyTorch ``select_topk_ref`` gives bitwise the same masks as the
  JAX ``select_topk_ref``, the Pallas kernel in interpret mode and the numpy
  stable-sort reference, over the corpus of ``tests/test_select_topk.py``:
  random masks, heavy ties, k in {0, 1, n}, ulp-apart non-ties, empty rows.
* On the CPU the dispatch takes the plain version; the kernel wrapper
  refuses CPU tensors (``tests/test_torch_kernels_on_card.py`` holds the
  kernel against its plain version on a card).
* Above the old 65,535-page ceiling (rows up to ``MAX_N``): the plain
  version equals the JAX ``select_topk_ref`` bitwise at 70,000 and 131,072
  pages, and numpy's stable sort up to ``MAX_N``.  The JAX ref numbers the
  boundary tier by a search over 17 bits of descending-index weights, so
  from 131,072 pages it cannot hold page 0's weight (2**17): with page 0 in
  the boundary tier and one page left to take it takes two.  Its compiled
  epoch loop refuses rows over 65,535 pages, so no JAX path meets it; the
  port's search covers ``n``'s bit length, and the edge is held to numpy.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_stub import given, settings, st

from repro.core import engine_jax  # noqa: E402
from repro.kernels.ref import select_topk_ref as jax_ref  # noqa: E402
from repro.kernels.select_topk import select_topk as pallas_select  # noqa: E402
from repro_torch.core import engine_torch  # noqa: E402
from repro_torch.kernels import ops, ref as torch_ref  # noqa: E402
from repro_torch.kernels import select_topk as torch_kernel  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
# one fixed shape for the corpus: the JAX paths trace once
B, N = 3, 256


def np_select(mask, heat, k, largest):
    """The numpy stable-sort reference: indices of the top-k candidates
    (ties by index, ascending), sorted."""
    idx = np.flatnonzero(mask)
    k = min(int(k), idx.size)
    key = -heat[idx] if largest else heat[idx]
    order = np.argsort(key, kind="stable")
    return np.sort(idx[order[:k]])


def _torch_plain(*args):
    return torch_ref.select_topk_ref(*(torch.from_numpy(np.asarray(a))
                                       for a in args))


def _jax(fn):
    def run(*args):
        return fn(*(jnp.asarray(a) for a in args))
    return run


IMPLS = {"torch_plain": _torch_plain,
         "jax_ref": _jax(jax_ref),
         "pallas_interpret": _jax(lambda *a: pallas_select(*a, interpret=True))}


def assert_conforms(p_mask, p_heat, d_mask, d_heat, kp, kd):
    """Every implementation equals the numpy reference, row by row."""
    for name, impl in IMPLS.items():
        pm, dm = (np.asarray(x) for x in impl(p_mask, p_heat, d_mask, d_heat,
                                              kp, kd))
        for b in range(p_mask.shape[0]):
            np.testing.assert_array_equal(
                np.flatnonzero(pm[b]),
                np_select(p_mask[b], p_heat[b], kp[b], True),
                err_msg=f"{name}: promote row {b} (k={kp[b]})")
            np.testing.assert_array_equal(
                np.flatnonzero(dm[b]),
                np_select(d_mask[b], d_heat[b], kd[b], False),
                err_msg=f"{name}: demote row {b} (k={kd[b]})")


def _corpus_case(seed: int, levels: int, density: float):
    rng = np.random.default_rng(seed)
    if levels:  # small integer grid => heavy priority ties
        p_heat = rng.integers(0, levels, size=(B, N)).astype(np.float32)
        d_heat = rng.integers(0, levels, size=(B, N)).astype(np.float32)
    else:
        p_heat = rng.uniform(0.0, 1e6, size=(B, N)).astype(np.float32)
        d_heat = rng.uniform(0.0, 1e6, size=(B, N)).astype(np.float32)
    p_mask = rng.uniform(size=(B, N)) < density
    d_mask = rng.uniform(size=(B, N)) < density
    edges = [0, 1, N, int(rng.integers(0, N + 1))]
    kp = np.array([edges[b % len(edges)] for b in range(B)], np.float32)
    kd = np.array([edges[(b + 1) % len(edges)] for b in range(B)],
                  np.float32)
    return p_mask, p_heat, d_mask, d_heat, kp, kd


# ---------------------------------------------------------------------------
# import isolation
# ---------------------------------------------------------------------------
def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.core.study\n"
        "import repro_torch.core.engine_torch, repro_torch.core.simulator\n"
        "import repro_torch.core.bo, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.select_topk, repro_torch.kernels.build\n"
        "import repro_torch.kernels.page_migrate\n"
        "import repro_torch.kernels.paged_attention\n"
        "import repro_torch.core.traffic, repro_torch.core.serving_torch\n"
        "import repro_torch.core.tiered_kv, repro_torch.serving_replay\n"
        "import repro_torch.kernels.flash_attention, repro_torch.configs\n"
        "import repro_torch.models, repro_torch.models.transformer\n"
        "import repro_torch.models.layers, repro_torch.models.registry\n"
        "import repro_torch.serve, repro_torch.serve.step\n"
        "import repro_torch.launch, repro_torch.launch.serve\n"
        "import repro_torch.launch.train, repro_torch.optim\n"
        "import repro_torch.train.step, repro_torch.train.trainer\n"
        "import repro_torch.data, repro_torch.ckpt\n"
        "import repro_torch.core.pages, repro_torch.core.engine\n"
        "import repro_torch.core.tiered_params\n"
        "import repro_torch.core.tune_service, repro_torch.core.drift\n"
        "import repro_torch.core.tune_online\n"
        "import repro_torch.core.tune_service.transport\n"
        "import repro_torch.core.tune_service.worker\n"
        "import repro_torch.core.tune_service.coordinator\n"
        "import repro_torch.launch.fleet\n"
        "from repro_torch.configs import all_arch_ids, get_config\n"
        "[get_config(a) for a in all_arch_ids()]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_imports_neither_jax_nor_repro():
    """chip_smoke.py imports torch, numpy, the standard library and the
    port only (read from its source: running it needs a card)."""
    import ast
    tree = ast.parse((SRC.parent / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert "jax" not in names and "repro" not in names, names
    assert "repro_torch" in names and "torch" in names


# ---------------------------------------------------------------------------
# counter hashes
# ---------------------------------------------------------------------------
def test_hash_words_bitwise_equal_to_reference():
    rng = np.random.default_rng(11)
    h = rng.integers(0, 2 ** 32, size=200_000, dtype=np.uint64) \
        .astype(np.uint32)
    w = rng.integers(0, 2 ** 32, size=200_000, dtype=np.uint64) \
        .astype(np.uint32)
    ht = torch.from_numpy(h.astype(np.int64))
    wt = torch.from_numpy(w.astype(np.int64))
    np.testing.assert_array_equal(engine_torch.mix32(ht).numpy(),
                                  engine_jax.mix32(h))
    np.testing.assert_array_equal(engine_torch.fold(ht, wt).numpy(),
                                  engine_jax.fold(h, w))
    np.testing.assert_array_equal(
        engine_torch.counter_hash(ht, 0x11, 7, wt).numpy(),
        engine_jax.counter_hash(h, np.uint32(0x11), np.uint32(7), w))
    np.testing.assert_array_equal(
        engine_torch.popcount32(ht).numpy(),
        np.asarray(jax.lax.population_count(jnp.asarray(h))))


@pytest.mark.parametrize("crn", [False, True])
def test_base_keys_and_uniforms_bitwise_equal_to_reference(crn):
    seeds = [7, 7, 3, 2 ** 31 + 5]
    keys = engine_torch.base_keys(seeds, 2, crn)
    ref = engine_jax.base_keys(seeds, 2, crn)
    assert keys.dtype == np.uint32
    np.testing.assert_array_equal(keys, ref)
    pages = np.arange(4096, dtype=np.uint32)[None, :]
    u_ref = np.asarray(engine_jax.counter_uniform(
        jnp.asarray(ref)[:, None], np.uint32(0x31), np.uint32(13),
        jnp.asarray(pages)))
    u = engine_torch.counter_uniform(
        torch.from_numpy(keys.astype(np.int64))[:, None], 0x31, 13,
        torch.from_numpy(pages.astype(np.int64))).numpy()
    assert u.dtype == np.float32
    np.testing.assert_array_equal(u, u_ref)


# ---------------------------------------------------------------------------
# selection corpus
# ---------------------------------------------------------------------------
@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       levels=st.sampled_from([0, 2, 3, 17, 255]),
       density=st.floats(0.05, 0.95))
def test_property_conformance(seed, levels, density):
    assert_conforms(*_corpus_case(seed, levels, density))


def test_all_priorities_tied_select_lowest_indices():
    mask = np.ones((B, N), bool)
    heat = np.full((B, N), 7.0, np.float32)
    k = np.array([0, 1, 13], np.float32)
    assert_conforms(mask, heat, mask, heat, k, k)
    pm, _ = _torch_plain(mask, heat, mask, heat, k, k)
    assert np.flatnonzero(pm[2].numpy()).tolist() == list(range(13))


def test_k_exceeding_candidates_takes_all():
    rng = np.random.default_rng(5)
    mask = rng.uniform(size=(B, N)) < 0.1
    heat = rng.integers(0, 3, size=(B, N)).astype(np.float32)
    k = np.full(B, N, np.float32)
    assert_conforms(mask, heat, mask, heat, k, k)


def test_empty_candidate_sets_select_nothing():
    z = np.zeros((B, N), bool)
    heat = np.ones((B, N), np.float32)
    k = np.full(B, 10.0, np.float32)
    assert_conforms(z, heat, z, heat, k, k)
    pm, dm = _torch_plain(z, heat, z, heat, k, k)
    assert not pm.any() and not dm.any()


def test_ulp_apart_values_are_not_ties():
    base = np.float32(1000.0)
    up = np.nextafter(base, np.float32(np.inf), dtype=np.float32)
    heat = np.tile(np.array([base, up] * (N // 2), np.float32), (B, 1))
    mask = np.ones((B, N), bool)
    k = np.full(B, N // 2, np.float32)
    assert_conforms(mask, heat, mask, heat, k, k)
    pm, dm = _torch_plain(mask, heat, mask, heat, k, k)
    assert np.flatnonzero(pm[0].numpy()).tolist() == list(range(1, N, 2))
    assert np.flatnonzero(dm[0].numpy()).tolist() == list(range(0, N, 2))


def test_fractional_counts_floor_like_reference():
    case = list(_corpus_case(3, 5, 0.5))
    case[4] = np.array([2.7, 0.4, 0.999], np.float32)
    case[5] = np.array([1e9, 5.99, 0.0], np.float32)
    assert_conforms(*case)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
@pytest.fixture
def restore_force():
    old = ops.FORCE
    yield
    ops.FORCE = old


def test_cpu_tensors_dispatch_to_plain_version(restore_force):
    args = [torch.from_numpy(np.asarray(a)) for a in _corpus_case(9, 4, 0.4)]
    before = torch_kernel.launches
    pm, dm = ops.select_topk(*args)
    ref_pm, ref_dm = torch_ref.select_topk_ref(*args)
    assert torch.equal(pm, ref_pm) and torch.equal(dm, ref_dm)
    assert torch_kernel.launches == before  # the plain version launches nothing
    ops.FORCE = "kernel"
    with pytest.raises(ValueError, match="FORCE"):
        ops.select_topk(*args)


def test_kernel_wrapper_refuses_cpu_tensors():
    args = [torch.from_numpy(np.asarray(a)) for a in _corpus_case(9, 4, 0.4)]
    with pytest.raises(ValueError, match="CUDA"):
        torch_kernel.select_topk(*args)


# ---------------------------------------------------------------------------
# the cluster kernel's algorithm and the variant rule (no card needed)
# ---------------------------------------------------------------------------
def _sliced_case(seed, B, n, levels, density):
    rng = np.random.default_rng(seed)
    if levels:
        p_heat = rng.integers(0, levels, size=(B, n)).astype(np.float32)
        d_heat = rng.integers(0, levels, size=(B, n)).astype(np.float32)
    else:
        p_heat = rng.uniform(-1e6, 1e6, size=(B, n)).astype(np.float32)
        d_heat = rng.uniform(0.0, 1e6, size=(B, n)).astype(np.float32)
    p_mask = rng.uniform(size=(B, n)) < density
    d_mask = rng.uniform(size=(B, n)) < density
    edges = [0, 1, n, int(rng.integers(0, n + 1))]
    kp = np.array([edges[b % 4] for b in range(B)], np.float32)
    kd = np.array([edges[(b + 1) % 4] for b in range(B)], np.float32)
    return p_mask, p_heat, d_mask, d_heat, kp, kd


def _assert_sliced_equals_reference(case, slices):
    pm, dm = torch_ref.select_topk_sliced_plain(
        *(torch.from_numpy(np.asarray(a)) for a in case), slices=slices)
    want_p, want_d = (np.asarray(x) for x in jax_ref(*(jnp.asarray(a)
                                                       for a in case)))
    np.testing.assert_array_equal(pm.numpy(), want_p)
    np.testing.assert_array_equal(dm.numpy(), want_d)


@pytest.mark.parametrize("slices", [1, 2, 8, 16])
@pytest.mark.parametrize("n", [1, 5, 15, 256, 1000])   # n < 16, n % slices
@pytest.mark.parametrize("levels,density", [(0, 0.5), (3, 0.9), (2, 0.05)])
def test_select_topk_sliced_plain_matches_reference(slices, n, levels,
                                                    density):
    _assert_sliced_equals_reference(
        _sliced_case(n * 31 + slices + levels, 4, n, levels, density), slices)


@pytest.mark.parametrize("slices", [1, 2, 8, 16])
def test_select_topk_sliced_plain_ties_across_slice_boundaries(slices):
    """One tied tier spanning every slice: the first `take` pages in index
    order are taken, whichever slices they fall in."""
    n = 100
    mask = np.ones((3, n), bool)
    heat = np.full((3, n), 7.0, np.float32)
    heat[:, ::9] = 9.0                       # a strict set in every slice
    k = np.array([0, 1 + 12, n], np.float32)
    _assert_sliced_equals_reference((mask, heat, mask, heat, k, k), slices)
    pm, _ = torch_ref.select_topk_sliced_plain(
        *(torch.from_numpy(a) for a in (mask, heat, mask, heat, k, k)),
        slices=slices)
    hot = set(range(0, n, 9))
    tied = [i for i in range(n) if i not in hot][:13 - len(hot)]
    assert np.flatnonzero(pm[1].numpy()).tolist() == sorted(hot | set(tied))


@pytest.mark.parametrize("B,n,want", [
    (8, 32783, "cluster"),     # the tuning loop at gups scale 1.0
    (1, 2048, "cluster"),      # the KV replay's engine epoch (64 x 32 pages)
    (3, 65535, "cluster"),
    (8, 65536, "cluster"),     # past the old 16-bit ceiling
    (1, torch_kernel.MAX_N, "cluster"),
    (2, 1025, "cluster"),
    (3, 1024, "block"),        # one tile of the block kernel
    (3, 256, "block"),
    (1, 1, "block"),
    (0, 0, "block"),
])
def test_select_topk_pick_variant(B, n, want):
    assert torch_kernel.pick_variant(B, n) == want


def test_select_topk_pick_variant_refuses_long_rows():
    for B, n in ((1, torch_kernel.MAX_N + 1), (-1, 8), (2, -3)):
        with pytest.raises(ValueError, match="at most"):
            torch_kernel.pick_variant(B, n)


def test_launch_counts_hold_under_threads():
    """8 threads x 1,000 counted launches through the wrappers' counting
    helper count 8,000 (the tune service's thread slots launch
    select_topk from several threads at once)."""
    import threading
    from repro_torch.kernels import build
    ops.reset_launch_counts()
    barrier = threading.Barrier(8)

    def count():
        barrier.wait()
        for _ in range(1000):
            build.count_launch(torch_kernel, "cluster")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=count) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    try:
        assert ops.launch_counts()["select_topk"] == 8000
        assert ops.launch_counts_by_variant()["select_topk"] == \
            {"block": 0, "cluster": 8000}
    finally:
        ops.reset_launch_counts()


def test_select_topk_variant_counts_reset():
    torch_kernel.launches_by_variant["cluster"] += 2
    ops.reset_launch_counts()
    assert torch_kernel.launches_by_variant == {"block": 0, "cluster": 0}
    # a cluster's CTA holds its slice's two u32 key rows in shared memory,
    # beside the kernel's static part, within what a block may use
    slice_ = -(-torch_kernel.MAX_N // torch_kernel.CLUSTER_SIZE)
    assert 2 * 4 * slice_ + torch_kernel.CLUSTER_STATIC_SMEM \
        <= torch_kernel.SMEM_PER_BLOCK
    assert 2 * 4 * (slice_ + 1) + torch_kernel.CLUSTER_STATIC_SMEM \
        > torch_kernel.SMEM_PER_BLOCK


# ---------------------------------------------------------------------------
# above the old 65,535-page ceiling
# ---------------------------------------------------------------------------
def _long_case(seed, B_, n, levels):
    """Random candidates over ``levels`` heat values (ties when small),
    k in {0, 1, n} and random in between."""
    rng = np.random.default_rng(seed)
    heat = [rng.integers(0, levels, (B_, n)).astype(np.float32)
            for _ in range(2)]
    mask = [rng.uniform(size=(B_, n)) < d for d in (0.3, 0.7)]
    ks = [np.array([0, 1, n] + list(rng.integers(2, n, B_ - 3)),
                   np.float32)[:B_] for _ in range(2)]
    return mask[0], heat[0], mask[1], heat[1], ks[0], ks[1]


@pytest.mark.parametrize("n", [70_000, 131_072])
@pytest.mark.parametrize("levels", [3, 4099])
def test_plain_matches_reference_above_old_ceiling(n, levels):
    case = _long_case(n + levels, 4, n, levels)
    pm, dm = _torch_plain(*case)
    jpm, jdm = _jax(jax_ref)(*case)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jpm))
    np.testing.assert_array_equal(dm.numpy(), np.asarray(jdm))


@pytest.mark.parametrize("n", [131_072, torch_kernel.MAX_N])
def test_plain_matches_stable_sort_up_to_max_n(n):
    p_mask, p_heat, d_mask, d_heat, kp, kd = _long_case(n, 4, n, 5)
    # row 1 (k = 1): every page a tied candidate, so page 0 alone is taken
    # -- the JAX ref's 17-bit edge
    p_mask[1], p_heat[1] = True, 2.0
    pm, dm = _torch_plain(p_mask, p_heat, d_mask, d_heat, kp, kd)
    for b in range(4):
        np.testing.assert_array_equal(
            np.flatnonzero(pm[b].numpy()),
            np_select(p_mask[b], p_heat[b], kp[b], True))
        np.testing.assert_array_equal(
            np.flatnonzero(dm[b].numpy()),
            np_select(d_mask[b], d_heat[b], kd[b], False))
    assert np.flatnonzero(pm[1].numpy()).tolist() == [0]
    # the cluster kernel's algorithm, on its 16 slices, gives the same masks
    spm, sdm = torch_ref.select_topk_sliced_plain(
        *(torch.from_numpy(a) for a in (p_mask, p_heat, d_mask, d_heat, kp,
                                        kd)),
        slices=torch_kernel.CLUSTER_SIZE)
    assert torch.equal(spm, pm) and torch.equal(sdm, dm)


def test_epoch_loop_supports_rows_past_the_old_ceiling():
    assert engine_torch.MAX_PAGES == torch_kernel.MAX_N >= 262_143
    assert engine_torch.supports("hemem", "elementwise", n_pages=65_536)
    assert engine_torch.supports("hemem", "elementwise",
                                 n_pages=engine_torch.MAX_PAGES)
    assert not engine_torch.supports("hemem", "elementwise",
                                     n_pages=engine_torch.MAX_PAGES + 1)
