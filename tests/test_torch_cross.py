"""The port's cross-attention families against the JAX reference, on the
CPU: whisper-base (encoder-decoder: every decoder layer attends over the
encoder's output) and llama-3.2-vision-11b (every ``cross_attn_every``-th
layer attends over projected patch embeddings), at their smoke configs.

Weights come from the reference's ``init`` and cross with
``params_from_jax``; tokens and the frontend stub input (``extra``) come
from numpy.  The reference initialises every cross layer's ``gate_x`` to
0, and the cross output is scaled by ``tanh(gate_x)``: with those weights
the cross path and the whole encoder add exactly nothing, and a port that
dropped them would still agree.  So every gate is set to a nonzero value in
the numpy tree before it goes to both sides, and the stub input is drawn at
scale 1 (the launcher's 0.02 barely moves a smoke model's logits);
``test_the_cross_path_moves_the_logits`` shows it weighs.

The reference's flash path runs as ``tests/test_torch_lm.py`` runs it:
``repro.kernels.ops.FORCE = "pallas"`` (the Pallas kernel in interpret
mode) or ``None`` (its jnp ref), set with ``monkeypatch``.  Cross-attention
and the encoder never take it (the reference's inline ``_sdpa``).

Tolerances, relative to the largest reference value, as
``tests/test_torch_lm.py`` states them: float32 1e-5 (the same casts, sums
in another order), bfloat16 3e-2 (``tests/test_models.py``'s bound);
gradients 1e-4 of a leaf's largest value (``tests/test_torch_train.py``).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.step import build_prefill_step as jax_prefill  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.step import build_prefill_step  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCHS = ["whisper-base", "llama-3.2-vision-11b"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: the reference's functions, jitted (the config static)
jax_forward = jax.jit(JT.forward, static_argnums=1)
jax_encode = jax.jit(JT._encode, static_argnums=1)
jax_loss = jax.jit(JT.loss_fn, static_argnums=1,
                   static_argnames="use_flash")
jax_decode = jax.jit(JT.decode_step, static_argnums=1)


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _gates(cfg) -> np.ndarray:
    """Nonzero cross gates, one per layer group: 0.5, 0.6, ..."""
    n_groups = cfg.n_layers // JT.pattern_period(cfg)
    return (0.5 + 0.1 * np.arange(n_groups)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _numpy_params(arch: str, dtype: str):
    """(JAX config, port config, the reference's init as numpy with every
    cross gate set nonzero)."""
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    params, _ = JT.init(jax.random.PRNGKey(0), jcfg)
    params = jax.tree.map(np.asarray, params)
    for k in JT._cross_layers(jcfg) & set(range(JT.pattern_period(jcfg))):
        assert not params["blocks"][k]["gate_x"].any()  # the reference's 0
        params["blocks"][k]["gate_x"] = _gates(jcfg)
    return jcfg, tcfg, params


@functools.lru_cache(maxsize=None)
def _models(arch: str, dtype: str):
    """(JAX config, JAX params, port config, port model) on the CPU."""
    jcfg, tcfg, params = _numpy_params(arch, dtype)
    model = T.params_from_jax(params, tcfg, device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, params), tcfg, model


def _fresh_model(arch: str, dtype: str):
    """A model of its own (gradients accumulate into its leaves)."""
    _, tcfg, params = _numpy_params(arch, dtype)
    return T.params_from_jax(params, tcfg, device="cpu")


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _extra(cfg, B, seed=5, scale=1.0):
    return (np.random.default_rng(seed).normal(
        size=registry.extra_shape(cfg, B)) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the cross layer alone, the encoder alone
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("H,KV,n_keys,cap,dtype", [
    (4, 4, 17, 0.0, "float32"), (8, 2, 33, 0.0, "float32"),
    (8, 2, 33, 50.0, "float32"), (8, 2, 33, 0.0, "bfloat16")])
def test_attn_apply_cross_matches(H, KV, n_keys, cap, dtype):
    """``attn_apply(cross_kv=)``: q from x without RoPE, every one of T
    precomputed keys attended (T not a multiple of any tile), then wo; no
    cache.  G = H / KV is 1 or 4."""
    jdt, tdt = DTYPES[dtype]
    acfg = JL.AttnCfg(d_model=32, n_heads=H, n_kv_heads=KV, head_dim=8,
                      logit_softcap=cap)
    tcfg = L.AttnCfg(**dataclasses.asdict(acfg))
    params, _ = JL.attn_init(jax.random.PRNGKey(n_keys), acfg, jdt)
    params = jax.tree.map(np.asarray, params)
    tparams = {k: T._tensor(v, "cpu") for k, v in params.items()}
    rng = np.random.default_rng(H + n_keys)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    kv = [rng.normal(size=(2, n_keys, KV, 8)).astype(np.float32)
          for _ in "kv"]
    pos = np.broadcast_to(np.arange(100, 105), (2, 5))  # ignored: no RoPE
    want, jcache = JL.attn_apply(
        params, acfg, jnp.asarray(x, jdt), jnp.asarray(pos),
        cross_kv=tuple(jnp.asarray(a, jdt) for a in kv))
    got, cache = L.attn_apply(
        tparams, tcfg, torch.from_numpy(x).to(tdt),
        torch.from_numpy(pos.copy()),
        cross_kv=tuple(torch.from_numpy(a).to(tdt) for a in kv))
    assert cache is None and jcache is None
    assert got.shape == (2, 5, 32) and got.dtype == tdt
    assert _rel_err(_np(got), _f32(want)) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches(dtype):
    """The whisper encoder alone: non-causal attention without RoPE (the
    inline ``_sdpa``), an MLP per layer, then ``enc_norm_f``."""
    jcfg, params, tcfg, model = _models("whisper-base", dtype)
    x = _extra(tcfg, 2)
    want = jax_encode(params, jcfg, jnp.asarray(x))
    got = T._encode(model, tcfg, torch.from_numpy(x))
    assert got.shape == (2, tcfg.enc_ctx, tcfg.d_model)
    assert got.dtype == tcfg.tdtype
    assert _rel_err(_np(got), _f32(want)) < TOL[dtype]


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_the_cross_encoder_and_vision_leaves(arch):
    """Every leaf of the reference's tree lands in the model, the bf16
    bits kept: ``cross``, ``norm_x`` and ``gate_x`` (0-d float32) on the
    cross layers only, ``encoder`` one block per encoder layer,
    ``enc_norm_f`` and ``vision_proj`` where the family has them."""
    jcfg, tcfg, params = _numpy_params(arch, "bfloat16")
    _, _, _, model = _models(arch, "bfloat16")
    period = JT.pattern_period(jcfg)
    cross = JT._cross_layers(jcfg)
    assert {i for i, b in enumerate(model.blocks) if b.cross is not None} \
        == cross
    assert all((b.norm_x is None) == (b.gate_x is None) == (b.cross is None)
               for b in model.blocks)
    for i in cross:
        g, k = divmod(i, period)
        blk = model.blocks[i]
        assert blk.gate_x.shape == () and blk.gate_x.dtype == torch.float32
        assert float(blk.gate_x) == float(params["blocks"][k]["gate_x"][g])
        for name in ("wq", "wk", "wv", "wo"):
            want = params["blocks"][k]["cross"][name][g]
            assert np.array_equal(
                blk.cross[name].detach().view(torch.int16).numpy(),
                want.view(np.int16))
    if jcfg.family == "encdec":
        assert len(model.encoder) == jcfg.enc_layers
        assert model.vision_proj is None
        for i, blk in enumerate(model.encoder):
            assert blk.cross is None and blk.kind == "attn"
            want = params["encoder"]["mlp"]["w_up"][i]
            assert np.array_equal(
                blk.mlp["w_up"].detach().view(torch.int16).numpy(),
                want.view(np.int16))
        assert np.array_equal(model.enc_norm_f["w"].numpy(),
                              params["enc_norm_f"]["w"])
    else:
        assert model.encoder is None and model.enc_norm_f is None
        assert model.vision_proj.shape == (jcfg.vision_dim, jcfg.d_model)
        assert np.array_equal(
            model.vision_proj.detach().view(torch.int16).numpy(),
            params["vision_proj"].view(np.int16))
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_builds_the_same_leaves_as_the_reference(arch):
    """``init`` on the CPU makes the reference's leaves (by count and
    shape), every cross gate 0, as the reference's ``init`` does."""
    cfg = get_config(arch, smoke=True)
    model = T.init(0, cfg, device="cpu")
    shapes, _ = JT.shape_init(jax.random.PRNGKey(0),
                              jax_config(arch, smoke=True))
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for x in jax.tree.leaves(shapes))
    gates = [b.gate_x for b in model.blocks if b.gate_x is not None]
    assert len(gates) == len(T._cross_layers(cfg)) > 0
    assert all(float(g) == 0.0 and g.dtype == torch.float32 for g in gates)
    assert not any(p.requires_grad for p in model.parameters())
    again = dict(T.init(0, cfg, device="cpu").named_parameters())
    assert all(torch.equal(p, again[k]) for k, p in model.named_parameters())


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------
MODES = [pytest.param("float32", 8, None, id="float32-sdpa-S8"),
         pytest.param("float32", 512, "pallas", id="float32-flash-S512-pallas"),
         pytest.param("float32", 512, None, id="float32-flash-S512-ref"),
         pytest.param("bfloat16", 8, None, id="bfloat16-sdpa-S8"),
         pytest.param("bfloat16", 512, None, id="bfloat16-flash-S512-ref")]


@pytest.mark.parametrize("dtype,S,force", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match(monkeypatch, arch, dtype, S, force):
    """S = 8: the reference's forward against the port's forward and
    prefill (its last position).  S = 512: the reference's
    build_prefill_step, whose decoder self-attention goes through flash
    (the Pallas kernel in interpret mode, or its jnp ref), against the
    port's.  The cross layers attend over ``extra``'s encoding or
    projection on both sides."""
    jcfg, params, tcfg, model = _models(arch, dtype)
    B = 2 if S == 8 else 1
    tokens, extra = _tokens(jcfg, B, S), _extra(jcfg, B)
    monkeypatch.setattr(jax_ops, "FORCE", force)
    tb = {"tokens": torch.from_numpy(tokens), "extra": torch.from_numpy(extra)}
    jb = {"tokens": jnp.asarray(tokens), "extra": jnp.asarray(extra)}
    got = build_prefill_step(tcfg)(model, tb)
    assert got.shape == (B, 1, tcfg.padded_vocab)
    if S == 8:
        want, _ = jax_forward(params, jcfg, jb["tokens"], jb["extra"])
        full, aux = T.forward(model, tcfg, tb["tokens"], tb["extra"])
        assert aux == 0.0 and full.shape == (B, S, tcfg.padded_vocab)
        assert full.dtype == tcfg.tdtype
        assert _rel_err(_np(full), _f32(want)) < TOL[dtype]
        want = want[:, -1:]
    else:
        want = jax.jit(jax_prefill(jcfg))(params, jb)
    assert _rel_err(_np(got), _f32(want)) < TOL[dtype]


@pytest.mark.parametrize("arch", ARCHS)
def test_the_cross_path_moves_the_logits(arch):
    """With the reference's zero gates another stub input leaves the
    logits bitwise as they were (on both sides); with the nonzero gates
    the tests use, it moves them by more than twice the bf16 tolerance
    (whisper-base by about 0.3, llama-3.2-vision-11b by about 0.075 of
    the largest logit)."""
    jcfg, params, tcfg, model = _models(arch, "bfloat16")
    tokens = torch.from_numpy(_tokens(tcfg, 2, 8))
    a, b = (torch.from_numpy(_extra(tcfg, 2, seed=s)) for s in (5, 6))
    moved = _rel_err(_np(T.forward(model, tcfg, tokens, a)[0]),
                     _np(T.forward(model, tcfg, tokens, b)[0]))
    assert moved > 2 * TOL["bfloat16"]
    zero = T.init(0, tcfg, device="cpu")
    assert torch.equal(T.forward(zero, tcfg, tokens, a)[0],
                       T.forward(zero, tcfg, tokens, b)[0])
    jzero, _ = JT.init(jax.random.PRNGKey(0), jcfg)
    ja, jb = (jax_forward(jzero, jcfg, jnp.asarray(tokens.numpy()),
                          jnp.asarray(e.numpy()))[0] for e in (a, b))
    assert np.array_equal(_f32(ja), _f32(jb))


def test_an_lm_arch_ignores_extra():
    """As in the reference, a decoder-only model takes ``extra`` and
    ignores it: the same logits as without it."""
    cfg = get_config("chatglm3-6b", smoke=True)
    model = T.init(0, cfg, device="cpu")
    tokens = torch.from_numpy(_tokens(cfg, 2, 8))
    extra = torch.randn(2, 4, 64)
    want, _ = T.forward(model, cfg, tokens)
    got, _ = T.forward(model, cfg, tokens, extra)
    assert torch.equal(got, want)
    assert torch.equal(
        build_prefill_step(cfg)(model, {"tokens": tokens, "extra": extra}),
        build_prefill_step(cfg)(model, {"tokens": tokens}))
    cache = T.decode_init(cfg, 2, 4, device="cpu")
    assert T.prime_cross_kv(model, cfg, cache, extra) is cache


def test_a_cross_family_without_its_frontend_input_is_refused():
    cfg = get_config("llama-3.2-vision-11b", smoke=True)
    model = T.init(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="needs its frontend stub input"):
        T.forward(model, cfg, torch.zeros((1, 4), dtype=torch.long))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prime_cross_kv_matches(arch, dtype):
    """``decode_init`` + ``prime_cross_kv`` + 8 decode steps against the
    reference's: the primed K/V per cross layer, then the logits of every
    step."""
    jcfg, params, tcfg, model = _models(arch, dtype)
    B, S = 2, 8
    tokens, extra = _tokens(jcfg, B, S, seed=2), _extra(jcfg, B, seed=3)
    jcache, _ = JT.decode_init(jcfg, B, S + 7)
    jcache = JT.prime_cross_kv(params, jcfg, jcache, jnp.asarray(extra))
    tcache = T.decode_init(tcfg, B, S + 7, device="cpu")
    T_len = tcfg.enc_ctx if tcfg.family == "encdec" else tcfg.n_patches
    cross = T._cross_layers(tcfg)
    for i, entry in enumerate(tcache):
        assert ("cross_kv" in entry) == (i in cross)
        if i in cross:
            assert entry["cross_kv"][0].shape == (B, T_len, tcfg.n_kv_heads,
                                                  tcfg.hd)
            assert not entry["cross_kv"][0].any()
    tcache = T.prime_cross_kv(model, tcfg, tcache, torch.from_numpy(extra))
    period = JT.pattern_period(jcfg)
    for i in cross:
        g, k = divmod(i, period)
        for got, want in zip(tcache[i]["cross_kv"], jcache[k]["cross_kv"]):
            assert got.dtype == tcfg.tdtype
            assert _rel_err(_np(got), _f32(want[g])) < TOL[dtype]
    err = 0.0
    for t in range(S):
        want, jcache = jax_decode(params, jcfg, jnp.asarray(tokens[:, t:t + 1]),
                             jnp.int32(t), jcache)
        got, tcache = T.decode_step(model, tcfg,
                                    torch.from_numpy(tokens[:, t:t + 1]), t,
                                    tcache)
        err = max(err, _rel_err(_np(got), _f32(want)))
    assert err < TOL[dtype]
    assert all(("cross_kv" in e) == (i in cross) for i, e in enumerate(tcache))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_within_the_port(arch):
    """Teacher-forced decode over the primed cache equals forward over the
    same stub input, position by position (as ``tests/test_models.py``
    holds the reference)."""
    _, _, tcfg, model = _models(arch, "bfloat16")
    B, S = 2, 8
    tokens = torch.from_numpy(_tokens(tcfg, B, S, seed=3))
    extra = torch.from_numpy(_extra(tcfg, B, seed=4))
    full, _ = T.forward(model, tcfg, tokens, extra, use_flash=False)
    cache = T.prime_cross_kv(model, tcfg,
                             T.decode_init(tcfg, B, S + 4, device="cpu"),
                             extra)
    outs = []
    for t in range(S):
        logits, cache = T.decode_step(model, tcfg, tokens[:, t:t + 1], t,
                                      cache)
        outs.append(logits[:, 0])
    assert _rel_err(_np(torch.stack(outs, 1)), _np(full)) < 3e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_generate_matches_the_jax_serve_loop(arch):
    """The port's launcher loop with ``extra`` on the CPU against a JAX
    decode loop primed the same way (``build_serve_step``'s logits are
    ``decode_step``'s), on the same weights, prompt
    and stub input, fed the port's tokens: logits agree at every step, and
    each port token is the reference's argmax wherever the reference's
    top-2 margin exceeds the tolerance."""
    jcfg, params, tcfg, model = _models(arch, "bfloat16")
    P, N = 8, 6
    prompt = launcher.make_prompt(tcfg, 2, P, device="cpu")
    extra = _extra(tcfg, 2, seed=7)
    ops.reset_launch_counts()
    res = launcher.generate(model, tcfg, prompt, N, keep_logits=True,
                            extra=torch.from_numpy(extra))
    assert not any(ops.launch_counts().values())
    assert res["tokens"].shape == (2, N) and res["tokens"].dtype == torch.int32
    jcache, _ = JT.decode_init(jcfg, 2, P + N + 1)
    jcache = JT.prime_cross_kv(params, jcfg, jcache, jnp.asarray(extra))

    def step(params, tokens, position, cache):  # build_serve_step's logits
        logits, cache = jax_decode(params, jcfg, tokens, position, cache)
        return None, logits, cache
    fed = prompt.numpy()
    for t in range(P):
        _, logits, jcache = step(params, jnp.asarray(fed[:, t:t + 1]),
                                 jnp.int32(t), jcache)
    want_prompt = _f32(logits[:, -1])
    tol = TOL["bfloat16"]
    scale = np.abs(want_prompt).max()
    assert _rel_err(_np(res["prompt_logits"]), want_prompt) < tol
    feed = [_np(res["prompt_logits"]).argmax(-1)] + \
        [res["tokens"][:, t].numpy() for t in range(N - 1)]
    want = []
    for t in range(N):
        _, logits, jcache = step(params, jnp.asarray(feed[t][:, None]),
                                 jnp.int32(P + t), jcache)
        want.append(_f32(logits[:, -1]))
    want = np.stack(want, 1)
    assert _rel_err(_np(res["logits"]), want) < tol
    top2 = np.sort(want, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > tol * scale
    assert clear.any()
    assert np.array_equal(res["tokens"].numpy()[clear],
                          want.argmax(-1)[clear])


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_main_runs_a_cross_arch_on_the_cpu(capsys, arch):
    """The launcher primes the cross K/V from its stub input: numpy
    ``default_rng(1)`` normals times 0.02 of ``registry.extra_shape``."""
    res = launcher.main(["--arch", arch, "--batch", "2", "--prompt-len", "5",
                         "--new-tokens", "3", "--device", "cpu"])
    cfg = get_config(arch, smoke=True)
    assert res["tokens"].shape == (2, 3)
    assert res["extra"].shape == registry.extra_shape(cfg, 2)
    want = np.random.default_rng(1).normal(
        size=registry.extra_shape(cfg, 2)).astype(np.float32) * 0.02
    assert np.array_equal(res["extra"].numpy(), want)
    assert f"{arch}: generated (2, 3) tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# training through the cross path
# ---------------------------------------------------------------------------
def _batch(cfg, B, S, seed=0):
    b = JaxSyntheticLM(cfg.vocab, S, B, seed=seed).batch_at(3)
    b["labels"][0, : S // 4] = -1
    b["extra"] = _extra(cfg, B, seed=seed + 11)
    return b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch, dtype):
    jcfg, params, tcfg, model = _models(arch, dtype)
    b = _batch(tcfg, 2, 16)
    want = jax_loss(params, jcfg, {k: jnp.asarray(v) for k, v in b.items()},
                    use_flash=False)
    with torch.no_grad():
        got = T.loss_fn(model, tcfg, tstep.to_device(b, "cpu"),
                        use_flash=False)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) <= TOL[dtype] * abs(float(want))


@functools.lru_cache(maxsize=None)
def _jax_grads(arch: str):
    """(batch, the reference's float32 gradients of ``loss_fn`` on it)."""
    jcfg, params, tcfg, _ = _models(arch, "float32")
    b = _batch(tcfg, 2, 16, seed=2)
    return b, jax.jit(jax.grad(lambda p: JT.loss_fn(
        p, jcfg, {k: jnp.asarray(v) for k, v in b.items()},
        use_flash=False)))(params)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference_per_leaf(arch, remat):
    """Every leaf's gradient against ``jax.grad``, per layer, float32:
    the cross weights, ``norm_x`` and ``gate_x`` of each cross layer, the
    encoder's blocks (stacked over its layers in the reference),
    ``enc_norm_f`` and ``vision_proj`` among them, each nonzero."""
    jcfg, params, tcfg, _ = _models(arch, "float32")
    tcfg = dataclasses.replace(tcfg, remat=remat)
    model = _fresh_model(arch, "float32").requires_grad_(True)
    b, jgrads = _jax_grads(arch)
    T.loss_fn(model, tcfg, tstep.to_device(b, "cpu"),
              use_flash=False).backward()
    period = JT.pattern_period(jcfg)
    new = 0
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] in ("blocks", "encoder"):
            i = int(parts[1])
            if parts[0] == "blocks":
                g, k = divmod(i, period)
                node = jgrads["blocks"][k]
            else:
                g, node = i, jgrads["encoder"]
            for q in parts[2:]:
                node = node[q]
            want = np.asarray(node[g])
        else:
            node = jgrads
            for q in parts:
                node = node[q]
            want = np.asarray(node)
        got = p.grad.numpy()
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name
        if set(parts) & {"cross", "norm_x", "gate_x", "encoder",
                         "enc_norm_f", "vision_proj"}:
            assert np.abs(got).max() > 0, name
            new += 1
    assert new >= (10 if jcfg.family == "vlm" else 20)
