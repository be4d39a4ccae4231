"""The port's LM serving stack against the JAX reference, on the CPU.

Weights come from the reference's ``init`` and cross with
``params_from_jax``; tokens come from numpy.  The reference's flash path
runs as its own tests run it: ``repro.kernels.ops.FORCE = "pallas"`` (the
Pallas kernel in interpret mode) or ``None`` (its jnp ref), set with
``monkeypatch``.  On the CPU the port's flash call takes its plain version.

Tolerances, relative to the largest reference logit (as
``tests/test_models.py`` measures decode against forward):

* float32: 1e-5 — the same casts and float32 sums in another order;
* bfloat16: 3e-2 (``tests/test_models.py``'s bound) — bf16 matmul outputs
  round at the same places, but their float32 accumulation order differs,
  and a one-ulp flip of a bf16 activation (2**-8 relative) carries through
  the layers.
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
from repro.models import registry as jax_registry  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import SHAPES as JAX_SHAPES  # noqa: E402
from repro.serve.step import build_prefill_step as jax_prefill  # noqa: E402
from repro.serve.step import build_serve_step as jax_serve  # noqa: E402
from repro_torch.configs import all_arch_ids, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fak  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.serve.step import build_prefill_step  # noqa: E402

DENSE = ["chatglm3-6b", "gemma2-9b", "h2o-danube-3-4b", "command-r-plus-104b"]
#: the cross-attention families (``tests/test_torch_cross.py``)
CROSS = ["whisper-base", "llama-3.2-vision-11b"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _jnp_f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _models(arch: str, dtype: str):
    """(JAX config, JAX params, port config, port model) on the CPU."""
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    params, _ = JT.init(jax.random.PRNGKey(0), jcfg)
    model = T.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return jcfg, params, tcfg, model


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


# ---------------------------------------------------------------------------
# configs and registry
# ---------------------------------------------------------------------------
def test_every_arch_config_matches_the_reference():
    from repro.configs import all_arch_ids as jax_ids
    assert all_arch_ids() == jax_ids() == registry.list_archs()
    for arch in all_arch_ids():
        for smoke in (False, True):
            a = dataclasses.asdict(get_config(arch, smoke=smoke))
            b = dataclasses.asdict(jax_config(arch, smoke=smoke))
            assert a == b, arch
        cfg, mod = registry.get_model(arch)
        jcfg, _ = jax_registry.get_model(arch)
        assert mod is T
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.padded_vocab == jcfg.padded_vocab
        assert T.pattern_period(cfg) == JT.pattern_period(jcfg)
        assert registry.extra_shape(cfg, 3) == jax_registry.extra_shape(
            jcfg, 3)
        for name, shape in SHAPES.items():
            assert registry.shape_applicable(cfg, shape) == \
                jax_registry.shape_applicable(jcfg, JAX_SHAPES[name])
    assert get_config("chatglm3-6b").tdtype == torch.bfloat16


def test_make_batch_from_numpy_and_torch_generators():
    cfg = get_config("chatglm3-6b", smoke=True)
    a = registry.make_batch(cfg, 2, 16, np.random.default_rng(3),
                            device="cpu")
    b = registry.make_batch(cfg, 2, 16, 3, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"], torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 16))))
    c = registry.make_batch(cfg, 2, 16, torch.Generator().manual_seed(3),
                            device="cpu")
    assert c["tokens"].shape == (2, 16) and "extra" not in c
    assert int(c["tokens"].min()) >= 0 and int(c["tokens"].max()) < cfg.vocab
    vlm = get_config("llama-3.2-vision-11b", smoke=True)
    assert registry.make_batch(vlm, 2, 4, 0, device="cpu")["extra"].shape \
        == registry.extra_shape(vlm, 2)


def test_check_supported_accepts_every_registry_config():
    """Every arch of the registry, full and smoke, the cross-attention
    families included (``tests/test_torch_cross.py``), is accepted; an
    unknown block kind or family is still refused."""
    for arch in all_arch_ids():
        for smoke in (False, True):
            T.check_supported(get_config(arch, smoke=smoke))
    assert {get_config(a).family for a in CROSS} == {"encdec", "vlm"}
    cfg = get_config("chatglm3-6b", smoke=True)
    with pytest.raises(ValueError, match="unknown block kinds"):
        T.check_supported(dataclasses.replace(
            cfg, layer_pattern=("attn", "conv")))
    with pytest.raises(ValueError, match="unknown family"):
        T.check_supported(dataclasses.replace(cfg, family="speech"))


def test_init_builds_the_weights_on_the_device_from_a_seed():
    cfg = get_config("gemma2-9b", smoke=True)
    a, b = T.init(0, cfg, device="cpu"), T.init(0, cfg, device="cpu")
    c = T.init(torch.Generator().manual_seed(1), cfg, device="cpu")
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert pa.keys() == pb.keys() == pc.keys()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa["embed"], pc["embed"])
    assert pa["embed"].shape == (cfg.padded_vocab, cfg.d_model)
    assert pa["embed"].dtype == torch.bfloat16
    assert pa["blocks.0.norm1"].dtype == torch.float32
    assert len(a.blocks) == cfg.n_layers
    assert not any(p.requires_grad for p in a.parameters())
    bound = 1.0 / np.sqrt(cfg.d_model)
    w = pa["blocks.1.attn.wq"].float()
    assert float(w.abs().max()) <= bound and float(w.std()) > bound / 4
    n = sum(p.numel() for p in a.parameters())
    shapes, _ = JT.shape_init(jax.random.PRNGKey(0),
                              jax_config("gemma2-9b", smoke=True))
    assert n == sum(x.size for x in jax.tree.leaves(shapes))


def test_params_from_jax_keeps_bf16_bits_and_layer_order():
    jcfg, params, tcfg, model = _models("gemma2-9b", "bfloat16")
    period = JT.pattern_period(jcfg)
    for i, blk in enumerate(model.blocks):
        g, k = divmod(i, period)
        want = np.asarray(params["blocks"][k]["attn"]["wq"][g])
        got = blk.attn["wq"].detach().view(torch.int16).numpy()
        assert np.array_equal(got, want.view(np.int16))
        assert blk.kind == jcfg.pattern[i]
    assert np.array_equal(model.embed.detach().view(torch.int16).numpy(),
                          np.asarray(params["embed"]).view(np.int16))


# ---------------------------------------------------------------------------
# layers, in float32
# ---------------------------------------------------------------------------
def test_rms_norm_and_layer_norm_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    w = rng.normal(size=48).astype(np.float32) * 0.1
    b = rng.normal(size=48).astype(np.float32)
    got = L.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(_np(got), np.asarray(JL.rms_norm(x, w)),
                               rtol=1e-6, atol=1e-6)
    got = L.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b))
    np.testing.assert_allclose(_np(got),
                               np.asarray(JL.layer_norm(x, w, b)),
                               rtol=1e-5, atol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = L.rms_norm(xb, torch.from_numpy(w))
    want = JL.rms_norm(jnp.asarray(x, jnp.bfloat16), w)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _jnp_f32(want))


@pytest.mark.parametrize("frac", [0.5, 1.0])
def test_apply_rope_matches(frac):
    """Interleaved pairs of the first ``frac * D`` dims; positions up to
    2,047 (the prefill length of the main path)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(6), np.arange(2042, 2048)])
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                       rotary_frac=frac)
    want = JL.apply_rope(x, pos, rotary_frac=frac)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if frac < 1:  # the second half passes through untouched
        np.testing.assert_array_equal(_np(got)[..., 8:], x[..., 8:])


def _attn_case(window, cap, seed=0):
    acfg = JL.AttnCfg(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                      rotary_frac=0.5, window=window, logit_softcap=cap)
    tcfg = L.AttnCfg(**dataclasses.asdict(acfg))
    params, _ = JL.attn_init(jax.random.PRNGKey(seed), acfg, jnp.float32)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    return acfg, tcfg, params, tparams


@pytest.mark.parametrize("S,force,window,cap", [
    (8, None, 0, 0.0), (8, None, 5, 50.0), (512, "pallas", 200, 50.0),
    (512, None, 0, 0.0)])
def test_attn_apply_prefill_matches(monkeypatch, S, force, window, cap):
    """S = 512 goes through flash (the Pallas kernel or its jnp ref on the
    JAX side, the plain version here), S = 8 through the inline _sdpa."""
    acfg, tcfg, params, tparams = _attn_case(window, cap)
    x = np.random.default_rng(2).normal(size=(1, S, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (1, S))
    monkeypatch.setattr(jax_ops, "FORCE", force)
    want, _ = JL.attn_apply(params, acfg, jnp.asarray(x), jnp.asarray(pos))
    before = fak.launches
    got, cache = L.attn_apply(tparams, tcfg, torch.from_numpy(x),
                              torch.from_numpy(pos.copy()))
    assert cache is None and fak.launches == before  # CPU: no launch
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window,max_len", [(0, 12), (4, 4)])
def test_attn_apply_decode_matches(window, max_len):
    """One token at a time through the cache; ``window=4`` with a 4-slot
    buffer wraps the ring twice over 10 steps."""
    acfg, tcfg, params, tparams = _attn_case(window, 30.0, seed=3)
    x = np.random.default_rng(4).normal(size=(2, 10, 32)).astype(np.float32)
    jcache = JL.kv_cache_init(acfg, 2, max_len, jnp.float32)
    tcache = L.kv_cache_init(tcfg, 2, max_len, torch.float32, device="cpu")
    for t in range(10):
        pos = np.full((2, 1), t)
        want, jcache = JL.attn_apply(params, acfg, jnp.asarray(x[:, t:t + 1]),
                                     jnp.asarray(pos), kv_cache=jcache)
        got, tcache = L.attn_apply(tparams, tcfg,
                                   torch.from_numpy(x[:, t:t + 1]),
                                   torch.from_numpy(pos), kv_cache=tcache)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        assert tcache[2] == int(jcache[2])
        np.testing.assert_allclose(_np(tcache[0]), np.asarray(jcache[0]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_apply_matches(kind):
    params, _ = JL.mlp_init(jax.random.PRNGKey(0), 16, 24, kind, jnp.float32)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    x = np.random.default_rng(5).normal(size=(2, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        _np(L.mlp_apply(tparams, torch.from_numpy(x), kind)),
        np.asarray(JL.mlp_apply(params, jnp.asarray(x), kind)),
        rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------
MODES = [pytest.param("float32", 8, None, id="float32-sdpa-S8"),
         pytest.param("float32", 512, "pallas", id="float32-flash-S512-pallas"),
         pytest.param("float32", 512, None, id="float32-flash-S512-ref"),
         pytest.param("bfloat16", 8, None, id="bfloat16-sdpa-S8"),
         pytest.param("bfloat16", 512, None, id="bfloat16-flash-S512-ref")]


@pytest.mark.parametrize("dtype,S,force", MODES)
@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_prefill_match(monkeypatch, arch, dtype, S, force):
    """S = 8: the reference's forward against the port's forward and
    prefill (its last position).  S = 512: the reference's
    build_prefill_step, whose attention goes through flash (the Pallas
    kernel in interpret mode, or its jnp ref), against the port's."""
    jcfg, params, tcfg, model = _models(arch, dtype)
    B = 2 if S == 8 else 1
    tokens = _tokens(jcfg, B, S)
    monkeypatch.setattr(jax_ops, "FORCE", force)
    got = build_prefill_step(tcfg)(model, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (B, 1, tcfg.padded_vocab)
    if S == 8:
        want, _ = JT.forward(params, jcfg, jnp.asarray(tokens))
        full, aux = T.forward(model, tcfg, torch.from_numpy(tokens))
        assert aux == 0.0 and full.shape == (B, S, tcfg.padded_vocab)
        assert full.dtype == (torch.float32 if tcfg.final_softcap
                              else tcfg.tdtype)
        assert _rel_err(_np(full), _jnp_f32(want)) < TOL[dtype]
        want = want[:, -1:]
    else:
        want = jax_prefill(jcfg)(params, {"tokens": jnp.asarray(tokens)})
    assert _rel_err(_np(got), _jnp_f32(want)) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches(arch, dtype):
    """The reference's decode loop and the port's, step by step; gemma2
    and h2o-danube (window 32 in the smoke config) wrap their rings."""
    jcfg, params, tcfg, model = _models(arch, dtype)
    B, S = 2, 40
    tokens = _tokens(jcfg, B, S, seed=2)
    jcache, _ = JT.decode_init(jcfg, B, S + 4)
    tcache = T.decode_init(tcfg, B, S + 4, device="cpu")
    jstep = jax.jit(JT.decode_step, static_argnums=1)
    err = 0.0
    for t in range(S):
        want, jcache = jstep(params, jcfg, jnp.asarray(tokens[:, t:t + 1]),
                             jnp.int32(t), jcache)
        got, tcache = T.decode_step(model, tcfg,
                                    torch.from_numpy(tokens[:, t:t + 1]), t,
                                    tcache)
        err = max(err, _rel_err(_np(got), _jnp_f32(want)))
    assert err < TOL[dtype]
    ring = [e["kv"][0].shape[1] for e in tcache]
    assert ring == [min(S + 4, jcfg.window) if JT._attn_cfg(jcfg, k).window
                    else S + 4 for k in jcfg.pattern]


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward_within_the_port(arch):
    """As ``tests/test_models.py`` holds the reference: teacher-forced
    decode logits equal forward logits position by position."""
    _, _, tcfg, model = _models(arch, "bfloat16")
    B, S = 2, 8
    tokens = torch.from_numpy(_tokens(tcfg, B, S, seed=3))
    full, _ = T.forward(model, tcfg, tokens, use_flash=False)
    cache = T.decode_init(tcfg, B, S + 4, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = T.decode_step(model, tcfg, tokens[:, t:t + 1], t,
                                      cache)
        outs.append(logits[:, 0])
    dec = torch.stack(outs, 1)
    assert _rel_err(_np(dec), _np(full)) < 3e-2


@pytest.mark.parametrize("arch", ["chatglm3-6b", "gemma2-9b"])
def test_launcher_generate_matches_the_jax_serve_loop(arch):
    """The port's launcher loop on the CPU against a JAX build_serve_step
    loop on the same weights and prompt, fed the port's tokens: logits
    agree at every step, and each port token is the reference's argmax
    wherever the reference's top-2 margin exceeds the tolerance.  gemma2's
    40-token prompt wraps its 32-slot ring."""
    jcfg, params, tcfg, model = _models(arch, "bfloat16")
    P, N = 40, 6
    prompt = launcher.make_prompt(tcfg, 2, P, device="cpu")
    res = launcher.generate(model, tcfg, prompt, N, keep_logits=True)
    assert res["tokens"].shape == (2, N) and res["tokens"].dtype == torch.int32
    jcache, _ = JT.decode_init(jcfg, 2, P + N + 1)
    step = jax.jit(jax_serve(jcfg))
    fed = prompt.numpy()
    for t in range(P):
        nxt, logits, jcache = step(params, jnp.asarray(fed[:, t:t + 1]),
                                   jnp.int32(t), jcache)
    want_prompt = _jnp_f32(logits[:, -1])
    tol = TOL["bfloat16"]
    scale = np.abs(want_prompt).max()
    assert _rel_err(_np(res["prompt_logits"]), want_prompt) < tol
    # the port fed its own argmax after the prompt, then its tokens
    feed = [_np(res["prompt_logits"]).argmax(-1)] + \
        [res["tokens"][:, t].numpy() for t in range(N - 1)]
    want = []
    for t in range(N):
        _, logits, jcache = step(params, jnp.asarray(feed[t][:, None]),
                                 jnp.int32(P + t), jcache)
        want.append(_jnp_f32(logits[:, -1]))
    want = np.stack(want, 1)
    assert _rel_err(_np(res["logits"]), want) < tol
    top2 = np.sort(want, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > tol * scale
    assert clear.any()
    assert np.array_equal(res["tokens"].numpy()[clear],
                          want.argmax(-1)[clear])


def test_launcher_main_runs_on_the_cpu(capsys):
    res = launcher.main(["--arch", "chatglm3-6b", "--batch", "2",
                         "--prompt-len", "5", "--new-tokens", "3",
                         "--device", "cpu"])
    assert res["tokens"].shape == (2, 3)
    assert "chatglm3-6b: generated (2, 3) tokens" in capsys.readouterr().out
