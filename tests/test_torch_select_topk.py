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
