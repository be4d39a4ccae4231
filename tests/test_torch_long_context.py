"""The sliding-window dense families past their window, and RoPE at long
positions, against the JAX reference on the CPU.

* ``rope_freqs`` bit for bit at every head dim and rotary fraction of the
  registry (torch's float32 ``pow`` is one ulp off XLA's at some
  exponents, D = 120 and 256 among them);
* ``apply_rope`` at positions 8,184-8,191 and 524,280-524,287 (the
  reference's ``SHAPES["long_500k"]``), where one ulp of a frequency
  grew to 3e-3 at D = 120;
* gemma2-9b and h2o-danube-3-4b cut to 2 layers of d_model 256 at their
  full head dims (256 and 120) with a window of 32: a prefill of 1,024
  tokens (the flash path: the reference's Pallas kernel in interpret mode
  and its jnp ref; 1,024 is a multiple of the Pallas kernel's key block,
  which gives NaN on a ragged key length), and 48 decode steps from
  position 524,280, which wrap the 32-slot ring.

Float32 throughout, within 1e-5 of the largest reference value: the same
casts, float32 sums in another order.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import SHAPES as JAX_SHAPES  # noqa: E402
from repro.serve.step import build_prefill_step as jax_prefill  # noqa: E402
from repro.serve.step import build_serve_step as jax_serve  # noqa: E402
from repro_torch.configs import all_arch_ids, get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.step import build_prefill_step  # noqa: E402
from repro_torch.serve.step import build_serve_step  # noqa: E402

TOL = 1e-5
#: (head dim, rotary fraction, theta) of every registry config, full and
#: smoke
ROPE = sorted({(c.hd, c.rotary_frac, c.rope_theta)
               for arch in all_arch_ids() for smoke in (False, True)
               for c in (get_config(arch, smoke=smoke),)})
LONG = JAX_SHAPES["long_500k"].seq_len  # 524,288
#: the sliding-window families at their full head dims, cut in depth and
#: width: (arch, n_heads, n_kv_heads)
NARROW = [("gemma2-9b", 2, 1), ("h2o-danube-3-4b", 4, 2)]


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def test_the_registry_head_dims_are_covered():
    dims = {hd for hd, _, _ in ROPE}
    assert {16, 64, 112, 120, 128, 256} <= dims
    assert (128, 0.5, 10000.0) in ROPE  # chatglm3-6b's half rotation


@pytest.mark.parametrize("hd,frac,theta", ROPE)
def test_rope_freqs_equal_the_reference_bit_for_bit(hd, frac, theta):
    rd = int(hd * frac)
    rd -= rd % 2
    want = np.asarray(JL.rope_freqs(hd, theta, rd))
    got = L.rope_freqs(hd, theta, rd).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("start", [8184, LONG - 8])
@pytest.mark.parametrize("D", [120, 256])
def test_apply_rope_matches_at_long_positions(D, start):
    rng = np.random.default_rng(D + start)
    x = rng.normal(size=(2, 8, 3, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(start, start + 8), (2, 8)).copy()
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    want = JL.apply_rope(x, pos)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@functools.lru_cache(maxsize=None)
def _models(arch: str, H: int, KV: int):
    """(JAX config, JAX params, port config, port model): 2 layers of
    d_model 256 at the arch's full head dim, window 32, float32."""
    full = get_config(arch)
    cut = dict(n_layers=2, d_model=256, n_heads=H, n_kv_heads=KV, d_ff=512,
               vocab=512, window=32, layer_pattern=full.layer_pattern[:2],
               dtype="float32", remat=False)
    jcfg = dataclasses.replace(jax_config(arch), **cut)
    tcfg = dataclasses.replace(full, **cut)
    assert tcfg.hd == full.hd and jcfg.hd == full.hd
    params, _ = JT.init(jax.random.PRNGKey(0), jcfg)
    model = T.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return jcfg, params, tcfg, model


@pytest.mark.parametrize("force", ["pallas", None])
@pytest.mark.parametrize("arch,H,KV", NARROW)
def test_prefill_past_the_window_matches(monkeypatch, arch, H, KV, force):
    jcfg, params, tcfg, model = _models(arch, H, KV)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (1, 1024))
    monkeypatch.setattr(jax_ops, "FORCE", force)
    want = jax_prefill(jcfg)(params, {"tokens": jnp.asarray(tokens)})
    got = build_prefill_step(tcfg)(model,
                                   {"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape
    assert _rel_err(_np(got), np.asarray(want)) < TOL


@pytest.mark.parametrize("arch,H,KV", NARROW)
def test_serve_step_from_the_long_500k_position_matches(arch, H, KV):
    """48 teacher-forced steps from position 524,280, which wrap the
    32-slot rings: the logits at every step.  (Not the cached keys: under
    ``jit`` XLA fuses the reference's ``1 / theta ** e`` and rounds some
    frequencies one ulp off its eager ``rope_freqs``, which the port
    equals; at this position that moves a cached key by up to 0.08, while
    the logits see only the angle between query and key.)"""
    jcfg, params, tcfg, model = _models(arch, H, KV)
    B, N, P0 = 2, 48, LONG - 8
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, (B, N))
    jcache, _ = JT.decode_init(jcfg, B, 64)
    tcache = T.decode_init(tcfg, B, 64, device="cpu")
    assert [e["kv"][0].shape[1] for e in tcache] == [32, 32]
    jstep = jax.jit(jax_serve(jcfg))
    tstep = build_serve_step(tcfg)
    err = 0.0
    for t in range(N):
        _, want, jcache = jstep(params, jnp.asarray(tokens[:, t:t + 1]),
                                jnp.int32(P0 + t), jcache)
        _, got, tcache = tstep(model, torch.from_numpy(tokens[:, t:t + 1]),
                               P0 + t, tcache)
        err = max(err, _rel_err(_np(got), np.asarray(want)))
    assert err < TOL
    assert [e["kv"][2] for e in tcache] == [N, N]
