"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a CUDA card.  A CUDA kernel has no CPU mode, so every test
here skips without a card; on a machine with one, run

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_on_card.py

This file imports neither jax nor the reference package, so it runs where
only torch is installed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref
from repro_torch.kernels import select_topk as sk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs the same checks on the card)")
    return torch.device("cuda")


def _case(seed, B, n, levels, density):
    rng = np.random.default_rng(seed)
    if levels:
        ph = rng.integers(0, levels, (B, n)).astype(np.float32)
        dh = rng.integers(0, levels, (B, n)).astype(np.float32)
    else:
        ph = rng.uniform(-1e6, 1e6, (B, n)).astype(np.float32)
        dh = rng.uniform(0.0, 1e6, (B, n)).astype(np.float32)
    pm = rng.uniform(size=(B, n)) < density
    dm = rng.uniform(size=(B, n)) < density
    kp = rng.integers(0, n + 2, B).astype(np.float32)
    kd = rng.integers(0, n + 2, B).astype(np.float32)
    kp[0], kd[0] = 0, n  # the edges: nothing, and every candidate
    return pm, ph, dm, dh, kp, kd


@pytest.mark.parametrize("B,n", [(3, 256), (8, 32783), (2, 65535), (1, 1)])
@pytest.mark.parametrize("levels", [0, 3, 255])
@pytest.mark.parametrize("density", [0.02, 0.6])
def test_select_topk_kernel_matches_plain(cuda_device, B, n, levels, density):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _case(B * n + levels, B, n, levels, density)]
    before = sk.launches
    pm, dm = ops.select_topk(*args)
    rpm, rdm = ref.select_topk_ref(*args)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    assert torch.equal(pm, rpm) and torch.equal(dm, rdm)


def test_select_topk_kernel_rejects_bad_inputs(cuda_device):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _case(0, 2, 64, 3, 0.5)]
    with pytest.raises(TypeError, match="dtype"):
        sk.select_topk(args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        sk.select_topk(args[0], args[1].t().contiguous().t(), *args[2:])
    big = torch.zeros((1, sk.MAX_N + 1), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        sk.select_topk(big, big.float(), big, big.float(),
                       torch.ones(1, device=cuda_device),
                       torch.ones(1, device=cuda_device))


@pytest.mark.parametrize("B,n", [(3, 256), (8, 32783), (2, 65535), (1, 1),
                                 (2, 3), (1, 2048), (4, 7), (2, 15)])  # n < C
@pytest.mark.parametrize("levels", [0, 3, 255])
@pytest.mark.parametrize("density", [0.02, 0.6])
def test_select_topk_cluster_kernel_matches_plain_and_block(
        cuda_device, B, n, levels, density):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _case(B * n + levels + 1, B, n, levels, density)]
    before = dict(sk.launches_by_variant)
    pm, dm = sk.select_topk(*args, variant="cluster")
    again = sk.select_topk(*args, variant="cluster")
    bpm, bdm = sk.select_topk(*args, variant="block")
    rpm, rdm = ref.select_topk_ref(*args)
    torch.cuda.synchronize()
    assert sk.launches_by_variant["cluster"] == before["cluster"] + 2
    assert sk.launches_by_variant["block"] == before["block"] + 1
    assert torch.equal(pm, rpm) and torch.equal(dm, rdm)
    assert torch.equal(pm, bpm) and torch.equal(dm, bdm)
    assert torch.equal(pm, again[0]) and torch.equal(dm, again[1])


@pytest.mark.parametrize("n", [65_536, 100_003, sk.MAX_N])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("levels", [3, 0])
def test_select_topk_kernels_past_the_old_ceiling(cuda_device, B, n, levels):
    """Rows longer than the 65,535 pages of the 16-bit boundary counters:
    both kernels bitwise equal to the plain version and on a rerun."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _case(n + B + levels, B, n, levels, 0.6)]
    rpm, rdm = ref.select_topk_ref(*args)
    for variant in sk.VARIANTS:
        pm, dm = sk.select_topk(*args, variant=variant)
        again = sk.select_topk(*args, variant=variant)
        torch.cuda.synchronize()
        assert torch.equal(pm, rpm) and torch.equal(dm, rdm), variant
        assert torch.equal(again[0], pm) and torch.equal(again[1], dm)


def test_select_topk_rule_takes_the_cluster_kernel_on_long_rows(cuda_device):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _case(11, 8, 32783, 17, 0.3)]
    ops.reset_launch_counts()
    pm, dm = ops.select_topk(*args)
    small = [torch.from_numpy(a).to(cuda_device)
             for a in _case(12, 3, 512, 17, 0.3)]
    ops.select_topk(*small)
    torch.cuda.synchronize()
    assert sk.launches_by_variant == {"block": 1, "cluster": 1}
    rpm, rdm = ref.select_topk_ref(*args)
    assert torch.equal(pm, rpm) and torch.equal(dm, rdm)
    with pytest.raises(ValueError, match="variant"):
        sk.select_topk(*args, variant="radix")


@pytest.mark.parametrize("B,n", [(3, 256), (1, 512), (8, 32783), (2, 15)])
@pytest.mark.parametrize("variant", sk.VARIANTS)
def test_select_topk_kernels_without_a_demote_side(cuda_device, B, n,
                                                   variant):
    """No demote side (the acquisition's call): each kernel's promote mask
    equals the one it computes beside a demote side, and no demote mask
    comes back; a demote side given in part is refused."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _case(B + n, B, n, 3, 0.6)]
    pm, _ = sk.select_topk(*args, variant=variant)
    alone, none = sk.select_topk(args[0], args[1], None, None, args[4], None,
                                 variant=variant)
    torch.cuda.synchronize()
    assert none is None and torch.equal(alone, pm)
    with pytest.raises(ValueError, match="together"):
        sk.select_topk(args[0], args[1], args[2], None, args[4], None)


@pytest.mark.parametrize("n", [40, 512, 1536])
@pytest.mark.parametrize("k", [0, 1, 5, "n"])
def test_topk_mask_kernel_matches_plain(cuda_device, n, k):
    """The BO acquisition's top-q (the promote side of select_topk on one
    row, heavy ties, a valid mask): the rule's kernel (block up to 1,024
    rows, cluster above) bitwise equal to the plain version."""
    k = n if k == "n" else k
    rng = np.random.default_rng(n + 7)
    ei = rng.uniform(0, 1, size=n).astype(np.float32)
    ei[::4] = ei[1]
    valid = rng.uniform(size=n) < 0.8
    scores = torch.from_numpy(ei)
    mask = torch.from_numpy(valid)
    want = ops.topk_mask(scores, k, mask)          # CPU: the plain version
    before = dict(sk.launches_by_variant)
    got = ops.topk_mask(scores.to(cuda_device), k, mask.to(cuda_device))
    torch.cuda.synchronize()
    variant = sk.pick_variant(1, n)
    assert sk.launches_by_variant[variant] == before[variant] + 1
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# page_migrate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,elems,ids", [
    (6, 64, ([0, -1], [2, 1])),                    # the row-0 no-op case
    (6, 64, ([2, 3, 2, 5, -1], [1, 0, 4, 4, 3])),  # duplicate destinations
    (5, 7, ([1, 4, 0], [3, 3, 2])),                # 14/28-byte rows
    (9, 4099, ([8, 0, 3, 3], [0, 8, -1, 5])),      # misaligned row starts
    (4, 64, ([], [])),                             # no lanes
])
def test_page_migrate_kernel_matches_plain(cuda_device, dtype, P, elems, ids):
    from repro_torch.kernels import page_migrate as pmk
    rng = np.random.default_rng(P * elems)
    dst = torch.from_numpy(rng.normal(size=(P, elems))).to(cuda_device, dtype)
    src = torch.from_numpy(rng.normal(size=(P, elems))).to(cuda_device, dtype)
    d = torch.tensor(ids[0], dtype=torch.int32, device=cuda_device)
    s = torch.tensor(ids[1], dtype=torch.int32, device=cuda_device)
    want = ref.page_migrate_plain(dst.clone(), src, d, s)
    before = pmk.launches
    got = ops.page_migrate(dst, src, d, s)
    torch.cuda.synchronize()
    assert got is dst and pmk.launches == before + 1
    assert torch.equal(got, want)


def test_page_migrate_kernel_on_a_serving_page(cuda_device):
    """256 lanes of 917,504-byte rows (chatglm3-6b's KV page), half of them
    no-ops, between two pools of different row counts."""
    from repro_torch.kernels import page_migrate as pmk
    g = torch.Generator(device=cuda_device).manual_seed(0)
    elems = 28 * 64 * 2 * 128
    dst = torch.randn((257, elems), generator=g, device=cuda_device
                      ).to(torch.bfloat16)
    src = torch.randn((600, elems), generator=g, device=cuda_device
                      ).to(torch.bfloat16)
    d = torch.randperm(257, generator=g, device=cuda_device)[:256].int()
    s = torch.randperm(600, generator=g, device=cuda_device)[:256].int()
    d[::2] = -1
    want = ref.page_migrate_plain(dst.clone(), src, d, s)
    pmk.page_migrate(dst, src, d, s)
    torch.cuda.synchronize()
    assert torch.equal(dst, want)


def test_page_migrate_kernel_rejects_bad_inputs(cuda_device):
    from repro_torch.kernels import page_migrate as pmk
    a = torch.zeros((4, 8), device=cuda_device)
    ids = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        pmk.page_migrate(a, a.clone(), ids.long(), ids)
    with pytest.raises(TypeError, match="bfloat16"):
        pmk.page_migrate(a, a.to(torch.bfloat16), ids, ids)
    with pytest.raises(ValueError, match="contiguous"):
        pmk.page_migrate(a, torch.zeros((8, 4), device=cuda_device).t(),
                         ids, ids)


# ---------------------------------------------------------------------------
# paged_attention
# ---------------------------------------------------------------------------
def _attention_case(device, dtype, B, H, KV, D, page, ppseq, P, seed=0,
                    layers=1):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, H, D))).to(device, dtype)
    k = torch.from_numpy(rng.normal(size=(P, layers, page, KV, D))
                         ).to(device, dtype)
    v = torch.from_numpy(rng.normal(size=(P, layers, page, KV, D))
                         ).to(device, dtype)
    table = np.stack([rng.choice(P, ppseq, replace=False) for _ in range(B)])
    table = np.where(rng.uniform(size=table.shape) < 0.25, -1, table)
    lengths = rng.integers(0, page * ppseq + 1, B)
    lengths[0] = 0                                   # an empty row
    lengths[-1] = page * ppseq                       # a full row
    if B > 2:
        lengths[1] = page // 2 + 1                   # a partial page
    return (q, k[:, 0], v[:, 0],
            torch.from_numpy(table.astype(np.int32)).to(device),
            torch.from_numpy(lengths.astype(np.int32)).to(device))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("B,H,KV,D,page,ppseq,P,layers", [
    (2, 8, 4, 64, 16, 4, 16, 1),
    (3, 4, 1, 128, 8, 8, 64, 1),
    (1, 16, 8, 64, 32, 2, 8, 1),
    (4, 2, 2, 128, 64, 4, 24, 3),      # G = 1, a layer view
    (8, 32, 2, 128, 64, 8, 40, 3),     # chatglm3-6b's group, a layer view
])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_paged_attention_kernel_matches_plain(cuda_device, dtype, tol, B, H,
                                              KV, D, page, ppseq, P, layers,
                                              cap):
    from repro_torch.kernels import paged_attention as pak
    args = _attention_case(cuda_device, dtype, B, H, KV, D, page, ppseq, P,
                           seed=B * H + D, layers=layers)
    want = ref.paged_attention_plain(*args, logit_softcap=cap)
    before = pak.launches
    got = ops.paged_attention(*args, logit_softcap=cap)
    torch.cuda.synchronize()
    assert pak.launches == before + 1 and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    empty = args[4] == 0
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))


SPLIT_DTYPES = [torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", SPLIT_DTYPES)
@pytest.mark.parametrize("B,H,KV,D,page,ppseq,P,layers,splits", [
    (2, 8, 4, 64, 16, 4, 16, 1, 1),
    (3, 4, 1, 128, 16, 8, 64, 1, 1),
    (1, 16, 8, 64, 32, 2, 8, 1, 1),
    (4, 2, 2, 128, 64, 4, 24, 3, 1),      # G = 1, a layer view
    (8, 32, 2, 128, 64, 8, 40, 3, 1),     # chatglm3-6b's group, a layer view
    (2, 8, 2, 64, 16, 40, 40, 1, 2),      # the fewest a share allows
    (3, 64, 2, 128, 32, 40, 90, 2, 3),    # G = 32 (two m-tiles), by work
    (3, 16, 1, 64, 16, 64, 200, 1, 4),    # more shares than resident pages
    (4, 32, 2, 128, 64, 64, 300, 1, 16),  # by SMs, long contexts
])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_paged_attention_split_kernel_matches_plain_and_walk(
        cuda_device, dtype, B, H, KV, D, page, ppseq, P, layers, splits, cap):
    """The split kernel at the split count its plan picks from the shape
    and pool (each case one edge of the plan on a 132-SM H100), against
    the plain version and the walk kernel; bitwise on a rerun.  Row 0 has
    length 0 and row 1 a partial page, so some shares hold no resident
    page."""
    from repro_torch.kernels import paged_attention as pak
    assert pak.split_plan(B, KV, ppseq, page, 132, pool_pages=P) == splits
    args = _attention_case(cuda_device, dtype, B, H, KV, D, page, ppseq, P,
                           seed=B * H + D + 1, layers=layers)
    assert pak.pick_variant(dtype, H // KV, D, page) == "split"
    want = ref.paged_attention_plain(*args, logit_softcap=cap)
    walk = pak.paged_attention(*args, logit_softcap=cap, variant="walk")
    before = pak.launches_by_variant["split"]
    got = ops.paged_attention(*args, logit_softcap=cap)
    again = ops.paged_attention(*args, logit_softcap=cap)
    torch.cuda.synchronize()
    assert pak.launches_by_variant["split"] == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=1e-2)
    torch.testing.assert_close(got.float(), walk.float(), atol=1e-2,
                               rtol=1e-2)
    empty = args[4] == 0
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))


def test_paged_attention_split_kernel_refuses_too_few_splits(cuda_device):
    from repro_torch.kernels import paged_attention as pak
    args = _attention_case(cuda_device, torch.bfloat16, 2, 8, 2, 64, 16, 40,
                           90)
    with pytest.raises(ValueError, match="at least 2 splits"):
        pak.paged_attention(*args, splits=1)
    with pytest.raises(ValueError, match="split kernel takes"):
        pak.paged_attention(*[a.float() if a.is_floating_point() else a
                              for a in args], variant="split")


def test_paged_attention_split_kernel_at_the_serving_shape(cuda_device):
    """q (64, 32, 128) bf16 over the layer-0 view of a (257, 28, 64, 2,
    128) pool, 4 resident pages a sequence: the rule's split kernel (one
    split) against the plain version and the walk kernel, reruns
    bitwise."""
    from repro_torch.kernels import paged_attention as pak
    g = torch.Generator(device=cuda_device).manual_seed(5)
    rng = np.random.default_rng(5)
    pool_k = torch.randn((257, 28, 64, 2, 128), generator=g,
                         device=cuda_device).to(torch.bfloat16)
    pool_v = torch.randn((257, 28, 64, 2, 128), generator=g,
                         device=cuda_device).to(torch.bfloat16)
    q = torch.randn((64, 32, 128), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    lengths = rng.integers(256, 2049, 64)
    table = np.full((64, 32), -1, np.int32)
    slots = rng.permutation(256)
    for b in range(64):
        pages = rng.choice((lengths[b] - 1) // 64 + 1, 4, replace=False)
        table[b, pages] = slots[4 * b:4 * b + 4]
    args = (q, pool_k[:, 0], pool_v[:, 0],
            torch.from_numpy(table).to(cuda_device),
            torch.from_numpy(lengths.astype(np.int32)).to(cuda_device))
    assert pak.split_plan(64, 2, 32, 64, 132, pool_pages=257) == 1
    want = ref.paged_attention_plain(*args)
    walk = pak.paged_attention(*args, variant="walk")
    ops.reset_launch_counts()
    got = ops.paged_attention(*args)
    again = ops.paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=1e-2)
    torch.testing.assert_close(got.float(), walk.float(), atol=1e-2,
                               rtol=1e-2)
    assert pak.launches_by_variant == {"walk": 0, "split": 2}
    # the strided view gives what a contiguous copy gives
    dense = pak.paged_attention(q, pool_k[:, 0].contiguous(),
                                pool_v[:, 0].contiguous(), *args[3:])
    assert torch.equal(dense, ops.paged_attention(*args))


def test_paged_attention_kernel_rejects_bad_inputs(cuda_device):
    from repro_torch.kernels import paged_attention as pak
    q, k, v, table, lengths = _attention_case(
        cuda_device, torch.float32, 2, 8, 4, 64, 16, 4, 16)
    with pytest.raises(TypeError, match="share"):
        pak.paged_attention(q.to(torch.bfloat16), k, v, table, lengths)
    with pytest.raises(TypeError, match="int32"):
        pak.paged_attention(q, k, v, table.long(), lengths)
    with pytest.raises(ValueError, match="aligned"):
        pak.paged_attention(q[..., :62].contiguous(), k[..., :62],
                            v[..., :62], table, lengths)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------
FLASH_CASES = [  # B, S, T, H, KV, D, causal, window, cap
    (1, 128, 128, 4, 4, 64, True, 0, 0.0),
    (2, 256, 256, 8, 2, 64, True, 0, 0.0),
    (1, 256, 256, 4, 1, 128, True, 128, 0.0),
    (2, 128, 128, 4, 4, 64, False, 0, 0.0),
    (1, 256, 256, 2, 2, 256, True, 0, 50.0),
    (1, 100, 100, 4, 2, 120, True, 0, 0.0),      # D = 120, ragged tiles
    (2, 200, 77, 4, 2, 32, True, 0, 30.0),       # S != T
    (1, 160, 160, 2, 1, 16, False, 48, 0.0),     # window without causality
    (1, 64, 16, 4, 2, 32, False, 8, 0.0),        # rows that see no key
    (1, 40, 40, 2, 2, 8, True, 0, 0.0),          # D = 8
    (1, 1100, 1100, 16, 8, 256, True, 512, 50.0),  # gemma2's head shape
    (4, 2048, 2048, 32, 2, 128, True, 0, 0.0),   # chatglm3-6b's prefill
    (4, 2048, 2048, 16, 8, 64, True, 0, 0.0),    # granite-moe-1b-a400m's
    # recurrentgemma-2b's local attention: D = 256 (wgmma), G = 10, window
    # 2,048 biting at S = 4,096
    (2, 4096, 4096, 10, 1, 256, True, 2048, 0.0),
    # the wgmma kernel's edges: S and T not multiples of its 128-row
    # tiles, S != T with a softcap, a window without causality, rows that
    # see no key
    (1, 1000, 1000, 8, 2, 128, True, 0, 0.0),
    (2, 300, 517, 4, 1, 64, True, 0, 30.0),
    (1, 640, 640, 8, 8, 128, False, 256, 0.0),
    (1, 192, 64, 4, 2, 128, False, 8, 0.0),
    # the same edges at D = 256 (its 64-key tiles and single Q buffer),
    # and G = 10 on one KV head without causality
    (1, 1000, 1000, 8, 1, 256, True, 0, 0.0),
    (2, 300, 517, 4, 2, 256, True, 0, 50.0),
    (1, 640, 640, 10, 1, 256, False, 256, 0.0),
    (1, 192, 64, 4, 2, 256, False, 8, 0.0),
    # the cross-attention models' decoder prefills: llama-3.2-vision-11b's
    # (D = 128, group size 4) and whisper-base's (D = 64, group size 1)
    (4, 2048, 2048, 32, 8, 128, True, 0, 0.0),
    (4, 512, 512, 8, 8, 64, True, 0, 0.0),
]


def _flash_inputs(device, dtype, B, S, T, H, KV, D):
    g = torch.Generator(device=device).manual_seed(S * H + D)
    return (torch.randn((B, S, H, D), generator=g, device=device).to(dtype),
            torch.randn((B, T, KV, D), generator=g, device=device).to(dtype),
            torch.randn((B, T, KV, D), generator=g, device=device).to(dtype))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,T,H,KV,D,causal,window,cap", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, tol, B, S,
                                              T, H, KV, D, causal, window,
                                              cap):
    from repro_torch.kernels import flash_attention as fak
    q, k, v = _flash_inputs(cuda_device, dtype, B, S, T, H, KV, D)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    want = ref.flash_attention_plain(q, k, v, **kw)
    before = fak.launches
    variant = fak.pick_variant(dtype, D)
    by_variant = fak.launches_by_variant[variant]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fak.launches == before + 1 and got.dtype == dtype
    assert fak.launches_by_variant[variant] == by_variant + 1
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,T,H,KV,D,causal,window,cap",
                         [c for c in FLASH_CASES if c[5] in (64, 128, 256)])
def test_flash_attention_mma_kernel_where_the_rule_picks_wgmma(
        cuda_device, B, S, T, H, KV, D, causal, window, cap):
    """The old bf16 kernel stays right at the head dims the wgmma kernel
    took over (it is timed against it there)."""
    from repro_torch.kernels import flash_attention as fak
    q, k, v = _flash_inputs(cuda_device, torch.bfloat16, B, S, T, H, KV, D)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    want = ref.flash_attention_plain(q, k, v, **kw)
    before = fak.launches_by_variant["mma"]
    got = fak.flash_attention(q, k, v, variant="mma", **kw)
    torch.cuda.synchronize()
    assert fak.launches_by_variant["mma"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_attention_kernel_reads_strided_views(cuda_device):
    """q, k and v as head-sliced views of wider tensors (the kernel reads
    through strides; nothing is copied)."""
    from repro_torch.kernels import flash_attention as fak
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn((2, 300, 8 + 2 + 2, 64), generator=g,
                      device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    got = fak.flash_attention(q, k, v)
    want = ref.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_wgmma_kernel_reads_strided_views(cuda_device, D):
    """The wgmma kernel's tensor maps over views: q, k and v sliced out of
    one fused (B, S, H + 2 KV, D) projection, and a batch that is a
    strided slice (every other row) of a larger one."""
    from repro_torch.kernels import flash_attention as fak
    g = torch.Generator(device=cuda_device).manual_seed(D)
    qkv = torch.randn((4, 333, 8 + 2 + 2, D), generator=g,
                      device=cuda_device).to(torch.bfloat16)[::2]
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    before = fak.launches_by_variant["wgmma"]
    got = fak.flash_attention(q, k, v, variant="wgmma")
    want = ref.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert fak.launches_by_variant["wgmma"] == before + 1
    assert got.is_contiguous() and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_attention_kernel_rejects_bad_inputs(cuda_device):
    from repro_torch.kernels import flash_attention as fak
    q = torch.zeros((1, 8, 4, 16), device=cuda_device)
    kv = torch.zeros((1, 8, 2, 16), device=cuda_device)
    with pytest.raises(TypeError, match="share"):
        fak.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="multiple of 8"):
        fak.flash_attention(q[..., :12].contiguous(), kv[..., :12].contiguous(),
                            kv[..., :12].contiguous())
    with pytest.raises(ValueError, match="is on"):
        fak.flash_attention(q, kv.cpu(), kv)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_recurrent_layer_on_the_card_matches_the_cpu_path(cuda_device, kind,
                                                          dtype, tol):
    """One recurrent layer (d_model 256, B = 2, S = 512: two mLSTM chunks)
    on the card against the port's CPU path on the same weights and input:
    the output and each leaf of the new state, relative to the largest CPU
    value.  The recurrences are PyTorch operations (no hand-written
    kernel); float32 products must not round to TF32."""
    from repro_torch.models import layers as L
    D, H = 256, 4
    gen = torch.Generator().manual_seed(0)
    if kind == "rglru":
        params = L.rglru_init(gen, D, int(1.5 * D), H, dtype=dtype,
                              device="cpu")
        apply = L.rglru_apply
    elif kind == "mlstm":
        params = L.mlstm_init(gen, D, H, dtype, "cpu")

        def apply(p, x):
            return L.mlstm_apply(p, x, H)
    else:
        params = L.slstm_init(gen, D, H, dtype, "cpu")
        apply = L.slstm_apply
    x = torch.randn((2, 512, D), generator=gen).to(dtype)
    want, want_state = apply(params, x)
    got, got_state = apply({k: v.to(cuda_device) for k, v in params.items()},
                           x.to(cuda_device))
    for g, w in zip((got,) + tuple(got_state), (want,) + tuple(want_state)):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        err = (g.cpu().float() - w.float()).abs().max() / w.float().abs().max()
        assert float(err) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_cross_layer_on_the_card_matches_the_cpu_path(cuda_device, dtype,
                                                      tol):
    """One full cross layer of llama-3.2-vision-11b at full width (self-
    attention, the cross sub-layer over 1,601 projected patches with its
    gate at 0.5, the MLP; B = 1, S = 128) on the card against the port's
    CPU path on the same weights and input, relative to the largest CPU
    value.  In float32 the gate set to 0 gives the output without the
    cross path, which must differ by more than 10 x the tolerance (about
    2e-3 of the largest value with unit-scale patches)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("llama-3.2-vision-11b"),
                              dtype="float32" if dtype == torch.float32
                              else "bfloat16")
    gen = torch.Generator().manual_seed(0)
    blk = T.init_layer(gen, cfg, "attn", "cpu", cross=True)
    blk.gate_x.fill_(0.5)
    proj = L.dense_init(gen, cfg.vision_dim, cfg.d_model, dtype, "cpu")
    x = torch.randn((1, 128, cfg.d_model), generator=gen).to(dtype)
    patches = torch.randn((1, cfg.n_patches, cfg.vision_dim), generator=gen)
    pos = torch.arange(128)[None]

    def run(b, device):
        memory = patches.to(device).to(dtype) @ proj.to(device)
        out, _, _ = T._layer(b, cfg, x.to(device), pos.to(device),
                             memory=memory)
        return out
    want = run(blk, "cpu")
    card = blk.to(cuda_device)
    got = run(card, cuda_device)
    err = (got.cpu().float() - want.float()).abs().max() \
        / want.float().abs().max()
    assert got.dtype == dtype and float(err) <= tol
    if dtype == torch.float32:
        card.gate_x.fill_(0.0)
        off = run(card, cuda_device)
        moved = (off.cpu() - want).abs().max() / want.abs().max()
        assert float(moved) > 10 * tol


@pytest.mark.parametrize("engine", ["hemem", "hmsdk", "memtis", "oracle"])
def test_segments_equal_the_whole_run_on_the_card(cuda_device, engine):
    """Carried segments equal the whole run bitwise on the card at a page
    count that is not a multiple of 4 (655): each epoch's trace row must
    start at the same alignment in both, as CUDA reductions vectorize by
    the pointer's alignment."""
    from repro_torch.core import simulator
    from repro_torch.core.workloads import make_workload
    wl = make_workload("gups", "8GiB-hot", threads=8, scale=0.02, seed=3)
    cfgs = [{}, {}] if engine == "oracle" else None
    if cfgs is None:
        from repro_torch.core.knobs import get_space
        space = get_space(engine)
        cfgs = [space.default_config(),
                space.sample(np.random.default_rng(5))]
    kw = dict(seeds=3, crn=True, device=cuda_device)
    whole = simulator.run_simulation_segment(wl, engine, cfgs,
                                             return_carry=True, **kw)
    parts, carry = [], None
    for lo, hi in ((0, 15), (15, 31), (31, 60)):
        out = simulator.run_simulation_segment(
            wl, engine, cfgs, epoch_start=lo, epoch_stop=hi, carry=carry,
            return_carry=True, **kw)
        parts.append(out["wall_ms"])
        carry = out["carry"]
    assert np.array_equal(np.concatenate(parts), whole["wall_ms"])
    assert np.array_equal(carry[4], whole["carry"][4])


@pytest.mark.parametrize("scheduler", [None, "asha"])
def test_fleet_on_the_card_equals_async_and_counts_launches(cuda_device,
                                                           scheduler):
    """A 2-worker process fleet on the card (spawned workers, each
    starting CUDA and loading select_topk before it greets) makes the
    async thread slots' study bitwise, and its receipt counts one
    select_topk launch per epoch its workers evaluated: at 655 pages a
    row is one tile, so every launch is the block kernel's."""
    from repro_torch.core import ExperimentSpec, SimOptions, Study, WorkloadSpec
    spec = ExperimentSpec(
        engine="hemem",
        workload=WorkloadSpec("gups", "8GiB-hot", threads=8, scale=0.02),
        options=SimOptions(seed=3, crn=True, device="cuda"))
    kw = dict(budget=8, seed=9, n_init=3, scheduler=scheduler)
    base = Study(spec).tune(executor="async", slots=2, **kw)
    r = Study(spec).tune(executor="fleet", workers=2, pool="process", **kw)
    assert r.trials == base.trials
    assert [(o.config, o.value) for o in r.history] == \
        [(o.config, o.value) for o in base.history]
    assert r.best_value == base.best_value
    assert r.default_value == base.default_value
    fs = r.fleet
    assert fs["n_expired_leases"] == 0 and fs["n_worker_deaths"] == 0
    assert fs["kernel_launches"]["select_topk"] == {
        "block": r.epochs_evaluated, "cluster": 0}
    if scheduler is None:
        assert r.epochs_evaluated == base.epochs_evaluated
    else:  # promotions re-derive their prefixes on the fleet
        assert r.epochs_evaluated > base.epochs_evaluated
