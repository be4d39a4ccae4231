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
