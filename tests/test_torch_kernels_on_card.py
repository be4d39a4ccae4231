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
        pytest.skip("needs a CUDA card: the select_topk kernel has no CPU "
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
