"""The port's plain ``flash_attention`` against the JAX reference, on the CPU.

The same inputs, made with numpy, go through the reference's Pallas kernel
in interpret mode and its jnp ``flash_attention_ref``, and through the
port's plain version (what ``repro_torch.kernels.ops`` runs for CPU
tensors; the CUDA kernel is held against this plain version on a card by
``tests/test_torch_kernels_on_card.py`` and ``chip_smoke.py``).

Tolerances are ``tests/test_kernels.py``'s: float32 within 2e-5 (float32
sums in another order), bfloat16 within 2e-2 (one bf16 rounding of the
output, 2**-8 relative, on values of order 1).  The cases are that file's
sweep plus a head dim of 120, recurrentgemma-2b's head layout scaled down,
query and key lengths that are not a multiple of the tile, S != T, a window
without causality, and rows that see no key.
Where T is not a multiple of the Pallas kernel's key block (128, or T when
T is smaller), the Pallas kernel in interpret mode reads NaN past the end
of k and v and returns NaN everywhere; those cases are held to the jnp ref
alone (ROADMAP queue 3).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fak  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_DT = {"float32": (jnp.float32, torch.float32, 2e-5),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

CASES = [
    # B, S, T, H, KV, D, causal, window, cap, dtype
    (1, 128, 128, 4, 4, 64, True, 0, 0.0, "float32"),
    (2, 256, 256, 8, 2, 64, True, 0, 0.0, "float32"),
    (1, 256, 256, 4, 1, 128, True, 128, 0.0, "float32"),
    (2, 128, 128, 4, 4, 64, False, 0, 0.0, "float32"),
    (1, 256, 256, 2, 2, 256, True, 0, 50.0, "float32"),
    (1, 128, 128, 4, 4, 64, True, 0, 0.0, "bfloat16"),
    # recurrentgemma-2b's head layout (D = 256, 10 query heads on one KV
    # head, a window), scaled down
    (1, 384, 384, 10, 1, 256, True, 128, 0.0, "bfloat16"),
    (1, 96, 96, 4, 2, 120, True, 0, 0.0, "float32"),     # D = 120
    (1, 96, 96, 4, 2, 120, True, 0, 0.0, "bfloat16"),
    (1, 200, 256, 4, 2, 32, True, 0, 0.0, "float32"),    # S % 128 != 0
    (1, 200, 200, 4, 2, 32, True, 0, 0.0, "float32"),    # T % 128 != 0
    (2, 200, 77, 4, 2, 32, True, 0, 30.0, "float32"),    # S != T
    (1, 160, 160, 2, 1, 16, False, 48, 0.0, "float32"),  # window, no causal
    (1, 160, 160, 2, 1, 16, False, 48, 0.0, "bfloat16"),
    (1, 64, 16, 4, 2, 32, False, 8, 0.0, "float32"),     # rows >= 23 see nothing
]


def _inputs(case, seed=0):
    B, S, T, H, KV, D = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, T, KV, D)).astype(np.float32),
            rng.normal(size=(B, T, KV, D)).astype(np.float32))


def _to_torch(x, tdtype):
    """A JAX array as a torch tensor of ``tdtype`` (bf16 bits preserved)."""
    a = np.asarray(x)
    if tdtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(tdtype)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_flash_attention_matches_pallas_and_ref(case):
    causal, window, cap, dtype = case[6:]
    jdt, tdt, tol = _DT[dtype]
    q, k, v = (jnp.asarray(a, jdt) for a in _inputs(case))
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    before = fak.launches
    got = ops.flash_attention(_to_torch(q, tdt), _to_torch(k, tdt),
                              _to_torch(v, tdt), **kw)
    assert fak.launches == before          # CPU tensors: the plain version
    assert got.dtype == tdt and got.shape == q.shape
    got = got.to(torch.float32).numpy()
    wants = [jref.flash_attention_ref(q, k, v, **kw)]
    T = case[2]
    if T % min(128, T) == 0:
        wants.append(pallas_flash(q, k, v, interpret=True, **kw))
    for want in wants:
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_rows_that_see_no_key_give_zeros():
    """Non-causal window 8 over 16 keys: query rows >= 23 see no key."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(CASES[-1]))
    out = ref.flash_attention_plain(q, k, v, causal=False, window=8)
    assert torch.equal(out[:, 23:], torch.zeros_like(out[:, 23:]))
    assert bool((out[:, :23].abs().sum(-1) > 0).all())


def test_plain_flash_attention_equals_dense_softmax():
    """One unblocked softmax per row (float64) gives the same numbers as
    the 512-key block recurrence when T spans three blocks."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 40, 4, 16)))
    k = torch.from_numpy(rng.normal(size=(1, 1100, 2, 16)))
    v = torch.from_numpy(rng.normal(size=(1, 1100, 2, 16)))
    got = ref.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=False, logit_softcap=20.0)
    s = torch.einsum("bskgd,btkd->bskgt", q.reshape(1, 40, 2, 2, 16), k)
    s = 20.0 * torch.tanh(s / 4.0 / 20.0)
    want = torch.einsum("bskgt,btkd->bskgd", torch.softmax(s, -1), v)
    torch.testing.assert_close(got, want.reshape(1, 40, 4, 16).float(),
                               atol=2e-5, rtol=2e-5)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((1, 8, 4, 16))
    kv = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="needs CUDA"):
        fak.flash_attention(q, kv, kv)
    with pytest.raises(TypeError, match="share"):
        fak.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(TypeError, match="share"):
        fak.flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="multiple of 8"):
        fak.flash_attention(torch.zeros((1, 8, 4, 12)),
                            torch.zeros((1, 8, 2, 12)),
                            torch.zeros((1, 8, 2, 12)))
    with pytest.raises(ValueError, match="at most 256"):
        fak.flash_attention(torch.zeros((1, 2, 1, 264)),
                            torch.zeros((1, 2, 1, 264)),
                            torch.zeros((1, 2, 1, 264)))
    with pytest.raises(ValueError, match="KV heads"):
        fak.flash_attention(torch.zeros((1, 8, 4, 16)),
                            torch.zeros((1, 8, 3, 16)),
                            torch.zeros((1, 8, 3, 16)))
    with pytest.raises(ValueError, match="batch or head dim"):
        fak.flash_attention(q, torch.zeros((2, 8, 2, 16)),
                            torch.zeros((2, 8, 2, 16)))
    wide = torch.zeros((1, 8, 2, 24))
    with pytest.raises(ValueError, match="aligned"):   # base 8 bytes off
        fak.flash_attention(q, wide[..., 2:18], wide[..., 2:18])
    with pytest.raises(ValueError, match="contiguous last dim"):
        fak.flash_attention(q, kv.transpose(2, 3).contiguous().transpose(2, 3),
                            kv)
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))


def test_kernel_is_built_from_its_source_and_names_the_tpu_kernel():
    assert "flash_attention" in build.KERNELS
    assert (ROOT / fak.SOURCE).is_file()
    assert build.library_path("flash_attention").parent == build.BUILD_DIR
    path, line = fak.REPLACES.split(":")
    src = (ROOT / path).read_text().splitlines()
    assert "pl.pallas_call" in src[int(line) - 1]
    assert "flash_attention" in ops.launch_counts()
    ops.reset_launch_counts()
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 128, "wgmma"),   # chatglm3-6b's prefill
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 120, "mma"),     # h2o-danube-3-4b
    (torch.bfloat16, 16, "mma"),      # the smoke configs
    (torch.bfloat16, 256, "wgmma"),   # gemma2-9b, recurrentgemma-2b
    (torch.float32, 128, "fma"),
    (torch.float32, 120, "fma"),
])
def test_variant_rule(dtype, D, want):
    assert fak.pick_variant(dtype, D) == want
    # the rule's choice passes the wrapper's checks for that variant
    q = torch.zeros((1, 8, 4, D), dtype=dtype)
    kv = torch.zeros((1, 8, 2, D), dtype=dtype)
    fak.check_inputs(q, kv, kv, want)


def test_variant_rule_refuses_other_dtypes():
    with pytest.raises(TypeError, match="no kernel"):
        fak.pick_variant(torch.float16, 128)


def test_launches_by_variant_reset_with_the_other_counters():
    assert set(fak.launches_by_variant) == {"wgmma", "mma", "fma"}
    fak.launches = 3
    fak.launches_by_variant["wgmma"] = 2
    fak.launches_by_variant["mma"] = 1
    ops.reset_launch_counts()
    assert ops.launch_counts()["flash_attention"] == 0
    assert fak.launches_by_variant == {"wgmma": 0, "mma": 0, "fma": 0}


@pytest.mark.parametrize("dtype,D,variant,match", [
    (torch.bfloat16, 128, "tma", "must be one of"),
    (torch.bfloat16, 128, "fma", "does not take"),
    (torch.float32, 128, "wgmma", "does not take"),
    (torch.float32, 64, "mma", "does not take"),
    (torch.bfloat16, 120, "wgmma", "head dims"),
    (torch.bfloat16, 192, "wgmma", "head dims"),
])
def test_kernel_wrapper_refuses_a_bad_variant(dtype, D, variant, match):
    q = torch.zeros((1, 8, 4, D), dtype=dtype)
    kv = torch.zeros((1, 8, 2, D), dtype=dtype)
    before = dict(fak.launches_by_variant)
    with pytest.raises(ValueError, match=match):
        fak.flash_attention(q, kv, kv, variant=variant)
    assert fak.launches_by_variant == before
