"""The port's plain ``page_migrate`` and ``paged_attention`` against the JAX
reference, on the CPU.

The same inputs, made with numpy, go through the reference's Pallas kernels
in interpret mode and its jnp refs, and through the port's plain versions
(what ``repro_torch.kernels.ops`` runs for CPU tensors; the CUDA kernels
are held against these plain versions on a card by
``tests/test_torch_kernels_on_card.py`` and ``chip_smoke.py``).

* ``page_migrate``: bitwise.  Id sets avoid the reference's row-0 case
  (an invalid lane is clamped to row 0 and writes that row's old contents
  back after the valid lanes), which the port does not copy: there a
  negative id is a no-op in every case (a port-only test).  Duplicate
  destinations resolve last-lane-wins, as the Pallas grid does.
* ``paged_attention``: float32 within 1e-5 (the summation order of the
  dot products and the softmax differs between frameworks), bfloat16
  within 1e-2 (one bf16 rounding of the output, 2**-8 relative); rows of
  length 0 give zeros; the logit softcap matches the jnp ref within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.page_migrate import page_migrate as pallas_migrate  # noqa: E402
from repro.kernels.paged_attention import paged_attention as pallas_attention  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import page_migrate as pm_kernel  # noqa: E402
from repro_torch.kernels import paged_attention as pa_kernel  # noqa: E402

_DT = {"float32": (np.float32, jnp.float32, torch.float32),
       "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _to_torch(x, tdtype):
    """A JAX array as a torch tensor of ``tdtype`` (bf16 bits preserved)."""
    a = np.asarray(x)
    if tdtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(tdtype)


def _to_np(t):
    return t.to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# page_migrate
# ---------------------------------------------------------------------------
def _migration_ids(rng, P, n, dups):
    """Lanes with valid and no-op ids that avoid the reference's row-0
    case: valid lanes never target row 0 and a no-op lane's non-negative
    destination is no valid lane's destination."""
    d = rng.integers(1, P, n) if dups else rng.choice(np.arange(1, P), n,
                                                      replace=False)
    s = rng.integers(0, P, n)
    noop = rng.uniform(size=n) < 0.3
    kind = rng.integers(0, 2, n)
    s = np.where(noop & (kind == 0), -1, s)
    d = np.where(noop & (kind == 1), -1, d)
    taken = set(d[~noop].tolist())
    for i in np.flatnonzero(noop & (kind == 0)):
        if d[i] in taken:
            d[i] = -1
    return d.astype(np.int32), s.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,elems,n,dups", [
    (8, 64, 4, False), (17, 256, 16, False), (4, 32, 1, False),
    (16, 40, 24, True), (9, 7, 5, False)])
def test_page_migrate_plain_matches_reference(dtype, P, elems, n, dups):
    _, jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(P * 1000 + elems + n)
    dst = jnp.asarray(rng.normal(size=(P, elems)), jdt)
    src = jnp.asarray(rng.normal(size=(P, elems)), jdt)
    d_ids, s_ids = _migration_ids(rng, P, n, dups)
    want = pallas_migrate(dst.copy(), src, jnp.asarray(d_ids),
                          jnp.asarray(s_ids), interpret=True)
    got = ops.page_migrate(_to_torch(dst, tdt), _to_torch(src, tdt),
                           torch.from_numpy(d_ids), torch.from_numpy(s_ids))
    assert torch.equal(got, _to_torch(want, tdt))
    if not dups:  # the jnp ref's scatter leaves duplicate order open
        ref_out = jref.page_migrate_ref(dst, src, jnp.asarray(d_ids),
                                        jnp.asarray(s_ids))
        assert torch.equal(got, _to_torch(ref_out, tdt))


def test_page_migrate_without_lanes_leaves_dst():
    """N = 0 (the Pallas kernel cannot take an empty grid)."""
    dst = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    before = dst.clone()
    empty = torch.zeros(0, dtype=torch.int32)
    assert torch.equal(ops.page_migrate(dst, torch.ones(4, 3), empty, empty),
                       before)


def test_page_migrate_duplicates_last_lane_wins():
    dst = torch.zeros(4, 3)
    src = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ops.page_migrate(dst, src, [2, 1, 2, 2, 3], [0, 1, 3, 1, -1])
    assert torch.equal(dst[2], src[1]) and torch.equal(dst[1], src[1])
    assert torch.equal(dst[0], torch.zeros(3))
    assert torch.equal(dst[3], torch.zeros(3))


def test_page_migrate_negative_ids_are_noops_in_the_row0_case():
    """The documented contract, which the reference breaks for row 0: the
    copy into row 0 survives a later no-op lane."""
    rng = np.random.default_rng(4)
    dst = torch.from_numpy(rng.normal(size=(5, 6)).astype(np.float32))
    src = torch.from_numpy(rng.normal(size=(5, 6)).astype(np.float32))
    before = dst.clone()
    out = ops.page_migrate(dst, src, [0, -1, 3], [2, 1, -1])
    assert out is dst
    assert torch.equal(dst[0], src[2])
    assert torch.equal(dst[1:], before[1:])


def test_page_migrate_rejects_mixed_dtypes_and_aliasing():
    a = torch.zeros(4, 8)
    with pytest.raises(TypeError, match="cast"):
        ops.page_migrate(a, a.to(torch.bfloat16), [0], [1])
    with pytest.raises(ValueError, match="share storage"):
        ops.page_migrate(a, a, [0], [1])
    with pytest.raises(ValueError, match="rows differ"):
        ops.page_migrate(a, torch.zeros(4, 9), [0], [1])


# ---------------------------------------------------------------------------
# paged_attention
# ---------------------------------------------------------------------------
#: the sweep of tests/test_kernels.py plus chatglm3-6b's group: G = 16,
#: D = 128, 64-token pages
SWEEP = [
    # B, H, KV, D, page, ppseq, P
    (2, 8, 4, 64, 16, 4, 16),
    (3, 4, 1, 128, 8, 8, 64),
    (1, 16, 8, 64, 32, 2, 8),
    (4, 32, 2, 128, 64, 4, 24),
]


def _attention_case(seed, B, H, KV, D, page, ppseq, P, holes=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D))
    kp = rng.normal(size=(P, page, KV, D))
    vp = rng.normal(size=(P, page, KV, D))
    table = np.stack([rng.choice(P, ppseq, replace=False) for _ in range(B)])
    lengths = rng.integers(1, page * ppseq + 1, B)
    if holes:  # non-resident pages and an empty row
        table = np.where(rng.uniform(size=table.shape) < 0.3, -1, table)
        lengths[0] = 0
    return q, kp, vp, table.astype(np.int32), lengths.astype(np.int32)


def _port_attention(case, tdt, **kw):
    q, kp, vp, table, lengths = case
    return ops.paged_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), torch.from_numpy(table),
        torch.from_numpy(lengths), **kw)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("B,H,KV,D,page,ppseq,P", SWEEP)
def test_paged_attention_plain_matches_reference(dtype, tol, B, H, KV, D,
                                                 page, ppseq, P):
    _, jdt, tdt = _DT[dtype]
    case = _attention_case(7, B, H, KV, D, page, ppseq, P)
    q, kp, vp = (jnp.asarray(a, jdt) for a in case[:3])
    table, lengths = jnp.asarray(case[3]), jnp.asarray(case[4])
    got = ops.paged_attention(_to_torch(q, tdt), _to_torch(kp, tdt),
                              _to_torch(vp, tdt), torch.from_numpy(case[3]),
                              torch.from_numpy(case[4]))
    assert got.dtype == tdt and got.shape == (B, H, D)
    for want in (pallas_attention(q, kp, vp, table, lengths, interpret=True),
                 jref.paged_attention_ref(q, kp, vp, table, lengths)):
        np.testing.assert_allclose(_to_np(got), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("B,H,KV,D,page,ppseq,P", SWEEP)
def test_paged_attention_holes_and_empty_rows(B, H, KV, D, page, ppseq, P):
    case = _attention_case(11, B, H, KV, D, page, ppseq, P, holes=True)
    got = _port_attention(case, torch.float32)
    want = jref.paged_attention_ref(*(jnp.asarray(a) for a in case))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(got[0], torch.zeros(H, D))      # length 0


@pytest.mark.parametrize("cap", [5.0, 50.0])
def test_paged_attention_softcap_matches_reference(cap):
    case = _attention_case(3, 2, 32, 2, 128, 64, 3, 12)
    got = _port_attention(case, torch.float32, logit_softcap=cap)
    want = jref.paged_attention_ref(*(jnp.asarray(a) for a in case),
                                    logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    plain = _port_attention(case, torch.float32)
    assert not torch.allclose(got, plain, atol=1e-3)   # the cap bites


def test_paged_attention_reads_a_layer_view_of_the_pool():
    """The serving path attends ``pool[:, 0]`` of a (P, layers, page, KV,
    D) pool; the strided view gives what a contiguous copy gives."""
    rng = np.random.default_rng(5)
    pool_k = torch.from_numpy(rng.normal(size=(9, 3, 16, 2, 64))).float()
    pool_v = torch.from_numpy(rng.normal(size=(9, 3, 16, 2, 64))).float()
    q = torch.from_numpy(rng.normal(size=(2, 8, 64))).float()
    table = torch.tensor([[4, -1, 2], [0, 8, 7]], dtype=torch.int32)
    lengths = torch.tensor([40, 33], dtype=torch.int32)
    view = ops.paged_attention(q, pool_k[:, 0], pool_v[:, 0], table, lengths)
    dense = ops.paged_attention(q, pool_k[:, 0].contiguous(),
                                pool_v[:, 0].contiguous(), table, lengths)
    assert torch.equal(view, dense)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_versions():
    ops.reset_launch_counts()
    _port_attention(_attention_case(1, *SWEEP[0]), torch.float32)
    ops.page_migrate(torch.zeros(3, 4), torch.ones(3, 4), [1], [2])
    assert ops.launch_counts() == {"select_topk": 0, "page_migrate": 0,
                                   "paged_attention": 0,
                                   "flash_attention": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        pm_kernel.page_migrate(torch.zeros(3, 4), torch.ones(3, 4),
                               torch.zeros(1, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32))
    q, kp, vp, table, lengths = _attention_case(1, *SWEEP[0])
    with pytest.raises(ValueError, match="CUDA"):
        pa_kernel.paged_attention(
            torch.from_numpy(q).float(), torch.from_numpy(kp).float(),
            torch.from_numpy(vp).float(), torch.from_numpy(table),
            torch.from_numpy(lengths))
    assert pa_kernel.REPLACES.startswith("src/repro/kernels/paged_attention")
    assert pm_kernel.REPLACES.startswith("src/repro/kernels/page_migrate")
    assert ref.page_migrate_plain is pm_kernel.page_migrate_plain


# ---------------------------------------------------------------------------
# the split kernel's algorithm and the variant rule (no card needed)
# ---------------------------------------------------------------------------
def _split_case(seed, B, H, KV, D, page, ppseq, P):
    """Holes in the table, a row of length 0 (row 0), a row whose every
    entry is -1 (row 1), a row with one resident page at its end (row 2),
    the rest random."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D))
    kp = rng.normal(size=(P, page, KV, D))
    vp = rng.normal(size=(P, page, KV, D))
    table = np.stack([rng.choice(P, ppseq, replace=False) for _ in range(B)])
    table = np.where(rng.uniform(size=table.shape) < 0.4, -1, table)
    lengths = rng.integers(1, page * ppseq + 1, B)
    lengths[0] = 0
    if B > 1:
        table[1] = -1
    if B > 2:
        table[2, :] = -1
        table[2, ppseq - 1] = 0
        lengths[2] = page * ppseq
    return q, kp, vp, table.astype(np.int32), lengths.astype(np.int32)


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("B,H,KV,D,page,ppseq,P", [
    (4, 2, 2, 64, 16, 6, 40),      # G = 1
    (4, 8, 2, 64, 16, 5, 40),      # G = 4
    (5, 32, 2, 128, 64, 4, 30),    # G = 16, chatglm3-6b's group
    (3, 32, 1, 32, 8, 9, 40),      # G = 32 (two m-tiles)
])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_paged_attention_split_plain_matches_reference(splits, B, H, KV, D,
                                                       page, ppseq, P, cap):
    case = _split_case(splits * 100 + H + D, B, H, KV, D, page, ppseq, P)
    tq, tk, tv, tt, tl = (torch.from_numpy(a) for a in case)
    got = ref.paged_attention_split_plain(tq.float(), tk.float(), tv.float(),
                                          tt, tl, logit_softcap=cap,
                                          splits=splits)
    want = jref.paged_attention_ref(*(jnp.asarray(a) for a in case),
                                    logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(got[0], torch.zeros(H, D))      # length 0
    assert torch.equal(got[1], torch.zeros(H, D))      # no resident page


def test_paged_attention_split_plain_more_splits_than_pages():
    """Splits beyond a sequence's resident pages are empty shares (m =
    -inf, l = 0) and combine without NaN."""
    case = _split_case(5, 3, 8, 2, 64, 16, 3, 12)
    tq, tk, tv, tt, tl = (torch.from_numpy(a).float() if a.dtype != np.int32
                          else torch.from_numpy(a) for a in case)
    got = ref.paged_attention_split_plain(tq, tk, tv, tt, tl, splits=7)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref.paged_attention_plain(tq, tk, tv, tt,
                                                              tl),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype,G,D,page,want", [
    (torch.bfloat16, 16, 128, 64, "split"),    # the serving path
    (torch.float16, 4, 64, 16, "split"),
    (torch.bfloat16, 32, 128, 32, "split"),    # two m-tiles
    (torch.bfloat16, 1, 64, 128, "split"),
    (torch.float32, 16, 128, 64, "walk"),      # no float32 mma
    (torch.bfloat16, 16, 120, 64, "walk"),     # D not compiled
    (torch.bfloat16, 16, 256, 64, "walk"),
    (torch.bfloat16, 16, 128, 8, "walk"),      # page not a k16 step
    (torch.float16, 16, 64, 24, "walk"),
])
def test_paged_attention_pick_variant(dtype, G, D, page, want):
    assert pa_kernel.pick_variant(dtype, G, D, page) == want


def test_paged_attention_pick_variant_refuses_empty_shapes():
    for G, D, page in ((0, 128, 64), (16, 0, 64), (16, 128, 0)):
        with pytest.raises(ValueError, match="no kernel"):
            pa_kernel.pick_variant(torch.bfloat16, G, D, page)


@pytest.mark.parametrize("args,want", [
    # the serving shape: 64 sequences x 2 KV heads on 132 SMs, 257 pool
    # pages (about 4 resident a sequence): one split, 128 CTAs
    ((64, 2, 32, 64, 132, 257), 1),
    # long contexts on few sequences: 64 resident pages of 256 units each
    ((4, 2, 64, 64, 132, 300), 16),
    # the pool caps the resident pages: 2 a sequence, 8 units, no split
    ((4, 2, 32, 64, 132, 8), 1),
    # the work caps the splits: 8 pages of 4 units = 32 units, 2 shares
    ((1, 1, 8, 64, 132, 100), 2),
    # one CTA per SM already: no split
    ((132, 1, 32, 64, 132, 10000), 1),
    # a share holds at most 32 pages
    ((64, 2, 100, 64, 132, 10), 4),
    ((64, 2, 33, 16, 132, 4000), 2),
    # tiny pages: 16-token pages give 1 unit each
    ((2, 1, 64, 16, 132, 1000), 4),
    # an empty pool: no page is resident, no split
    ((8, 2, 16, 64, 132, 0), 1),
])
def test_split_plan(args, want):
    assert pa_kernel.split_plan(*args) == want


def test_split_plan_refuses_empty_shapes():
    for args in ((0, 2, 32, 64, 132, 9), (4, 0, 32, 64, 132, 9),
                 (4, 2, 0, 64, 132, 9), (4, 2, 32, 0, 132, 9),
                 (4, 2, 32, 64, 0, 9), (4, 2, 32, 64, 132, -1)):
        with pytest.raises(ValueError, match="no split plan"):
            pa_kernel.split_plan(*args)


def test_reset_clears_launches_by_variant():
    pa_kernel.launches_by_variant["split"] += 3
    ops.reset_launch_counts()
    assert pa_kernel.launches_by_variant == {"walk": 0, "split": 0}
    assert ops.launch_counts_by_variant()["paged_attention"] == \
        {"walk": 0, "split": 0}
