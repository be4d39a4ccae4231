"""The port's recurrent layers (RG-LRU, mLSTM, sLSTM) against the JAX
reference, on the CPU: each layer alone, then the recurrentgemma-2b and
xlstm-1.3b smoke configs through forward, prefill, decode, the launcher,
``loss_fn``, its gradients and whole train steps.

Weights come from the reference's ``init`` / ``*_init`` and cross with
``params_from_jax``; inputs and states come from numpy.  The reference's
flash path (recurrentgemma's local-attention layer at S = 512) runs as
``tests/test_torch_lm.py`` runs it: ``FORCE = "pallas"`` (the Pallas
kernel in interpret mode) or ``None`` (its jnp ref).

Tolerances, relative to the largest reference value:

* float32: 1e-5 — the same casts and float32 sums in another order (the
  sLSTM forget gate is ``-softplus(-f)`` on both sides, as the reference
  writes it, and needs no more);
* bfloat16: 3e-2 (``tests/test_models.py``'s bound, as in
  ``tests/test_torch_lm.py``): bf16 products round at the same places, but
  after float32 sums in another order, and one ulp of an activation
  carries through the recurrence;
* ``associative_scan`` against ``jax.lax.associative_scan``: 1e-6 (the
  same tree of float32 combinations; products that underflow are flushed
  to zero by XLA and kept as denormals by torch, 2**-126 apart at most);
  against a sequential loop, 1e-5 (another association of the same
  products);
* ``loss_fn``, gradients and train steps: ``tests/test_torch_train.py``'s
  (1e-5 on the loss, 1e-4 of a leaf's largest value on a gradient, 1e-4 on
  the losses and grad norms of 3 steps).

The reference's mLSTM clamps its within-chunk decay weights but not the
state it carries across chunks, so decode (chunks of one token) and a
prefill of one chunk compute different functions
(``test_the_reference_mlstm_decode_is_its_chunk_1_forward``; ROADMAP queue
3 b).  The port copies it as it is, so xlstm's decode is held to a forward
whose mLSTM layers run at chunk 1 (``mlstm_apply``'s own ``chunk``
argument, set with ``functools.partial``).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.step import build_prefill_step as jax_prefill  # noqa: E402
from repro.serve.step import build_serve_step as jax_serve  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.step import build_prefill_step  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCHS = ["recurrentgemma-2b", "xlstm-1.3b"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MLSTM_APPLY = L.mlstm_apply
JAX_MLSTM_APPLY = JL.mlstm_apply


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _torch(a) -> torch.Tensor:
    return T._tensor(np.asarray(a), "cpu")


def _tree_err(got, want) -> float:
    """Largest relative error over the leaves of two (nested) tuples."""
    if isinstance(want, (tuple, list)):
        return max(_tree_err(g, w) for g, w in zip(got, want))
    return _rel_err(_np(got), _f32(want))


@functools.lru_cache(maxsize=None)
def _models(arch: str, dtype: str):
    """(JAX config, JAX params, port config, port model) on the CPU."""
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    params, _ = JT.init(jax.random.PRNGKey(0), jcfg)
    model = T.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return jcfg, params, tcfg, model


def _fresh_model(arch: str, dtype: str):
    """A model of its own (training changes its weights)."""
    jcfg, params, tcfg, _ = _models(arch, dtype)
    return T.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                             device="cpu")


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _chunk_1(monkeypatch):
    """Both packages' mLSTM layers at chunk 1 (what decode computes)."""
    monkeypatch.setattr(L, "mlstm_apply",
                        functools.partial(MLSTM_APPLY, chunk=1))
    monkeypatch.setattr(JL, "mlstm_apply",
                        functools.partial(JAX_MLSTM_APPLY, chunk=1))


# ---------------------------------------------------------------------------
# the log-depth scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 2, 7, 64, 513])
def test_associative_scan_matches_jax_and_a_sequential_loop(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 6)).astype(np.float32)
    b = rng.normal(size=(2, S, 6)).astype(np.float32)
    aa, bb = L.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    ja, jb = jax.lax.associative_scan(
        lambda c1, c2: (c1[0] * c2[0], c1[1] * c2[0] + c2[1]),
        (jnp.asarray(a), jnp.asarray(b)), axis=1)
    assert aa.shape == bb.shape == (2, S, 6)
    # XLA on the CPU flushes float32 denormals to zero, torch does not:
    # products below 2**-126 differ by at most that much
    np.testing.assert_allclose(_np(aa), np.asarray(ja), rtol=1e-6,
                               atol=2.0 ** -126)
    np.testing.assert_allclose(_np(bb), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)
    h = np.zeros((2, 6), np.float32)
    p = np.ones((2, 6), np.float32)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        p = p * a[:, t]
        assert _rel_err(_np(bb[:, t]), h) < 1e-5
        assert _rel_err(_np(aa[:, t]), p) < 1e-5


# ---------------------------------------------------------------------------
# each layer alone
# ---------------------------------------------------------------------------
D_MODEL, HEADS, BATCH = 32, 2, 2


def _layer_case(kind, dtype, seed=0):
    """(reference params, port params, reference apply, port apply, random
    state as numpy arrays) of one layer at d_model 32."""
    jdt, _ = DTYPES[dtype]
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    B, D, H = BATCH, D_MODEL, HEADS
    if kind == "rglru":
        R = int(1.5 * D)
        params, _ = JL.rglru_init(key, D, R, H, dtype=jdt)
        state = (rng.normal(size=(B, 3, R)).astype(np.float32),
                 rng.normal(size=(B, R)).astype(np.float32))
        return (params, state, JL.rglru_apply,
                lambda p, x, s: L.rglru_apply(p, x, s))
    if kind == "mlstm":
        params, _ = JL.mlstm_init(key, D, H, jdt)
        hd, hv = D // H, 2 * D // H
        state = (rng.normal(size=(B, H, hd, hv)).astype(np.float32) * 0.1,
                 rng.normal(size=(B, H, hd)).astype(np.float32) * 0.1)
        return (params, state,
                lambda p, x, s: JL.mlstm_apply(p, x, H, s, chunk=4),
                lambda p, x, s: L.mlstm_apply(p, x, H, s, chunk=4))
    params, _ = JL.slstm_init(key, D, H, jdt)
    state = (rng.normal(size=(B, D)).astype(np.float32) * 0.1,
             rng.normal(size=(B, D)).astype(np.float32),
             rng.uniform(1.0, 2.0, (B, D)).astype(np.float32),
             rng.normal(size=(B, D)).astype(np.float32) * 0.1)
    return params, state, JL.slstm_apply, L.slstm_apply


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_layer_apply_matches_reference(kind, dtype, with_state):
    """Prefill from zeros, and from a random state (RG-LRU's conv tail in
    the model dtype, everything else float32); the mLSTM at chunk 4 over
    12 positions (three chunks).  Outputs and new states."""
    jdt, tdt = DTYPES[dtype]
    params, state, japply, tapply = _layer_case(kind, dtype)
    tparams = {k: _torch(v) for k, v in params.items()}
    x = np.random.default_rng(7).normal(size=(BATCH, 12, D_MODEL)).astype(
        np.float32)
    if with_state:
        if kind == "rglru":
            state = (state[0].astype(jdt), state[1])
        jstate = tuple(jnp.asarray(s) for s in state)
        tstate = tuple(_torch(np.asarray(s)) for s in jstate)
    else:
        jstate = tstate = None
    want, want_state = japply(params, jnp.asarray(x, jdt), jstate)
    got, got_state = tapply(tparams, torch.from_numpy(x).to(tdt), tstate)
    assert got.dtype == tdt and got.shape == (BATCH, 12, D_MODEL)
    assert _rel_err(_np(got), _f32(want)) < TOL[dtype]
    assert len(got_state) == len(want_state)
    for g, w in zip(got_state, want_state):
        assert g.shape == w.shape and g.dtype == _torch(np.asarray(w)).dtype
    assert _tree_err(got_state, want_state) < TOL[dtype]


def test_layer_inits_make_the_reference_shapes_and_dtypes():
    gen = torch.Generator().manual_seed(0)
    for kind, jinit, tinit in (
            ("rglru", lambda k: JL.rglru_init(k, 32, 48, 2),
             lambda: L.rglru_init(gen, 32, 48, 2, device="cpu")),
            ("mlstm", lambda k: JL.mlstm_init(k, 32, 2),
             lambda: L.mlstm_init(gen, 32, 2, device="cpu")),
            ("slstm", lambda k: JL.slstm_init(k, 32, 2),
             lambda: L.slstm_init(gen, 32, 2, device="cpu"))):
        want, _ = jinit(jax.random.PRNGKey(0))
        got = tinit()
        assert got.keys() == want.keys(), kind
        for name, w in want.items():
            assert tuple(got[name].shape) == w.shape, (kind, name)
            assert got[name].dtype == _torch(np.asarray(w)).dtype, name
    lam = L.rglru_init(gen, 32, 48, 2, device="cpu")["lambda_p"]
    np.testing.assert_allclose(_np(lam), np.linspace(4.0, 9.0, 48),
                               rtol=1e-6)
    assert float(L.slstm_init(gen, 32, 2, device="cpu")["norm"].abs().max()) \
        == 0.0
    for got, want in ((L.rglru_state_init(3, 48, device="cpu"),
                       JL.rglru_state_init(3, 48)),
                      (L.mlstm_state_init(3, 32, 2, device="cpu"),
                       JL.mlstm_state_init(3, 32, 2)),
                      (L.slstm_state_init(3, 32, device="cpu"),
                       JL.slstm_state_init(3, 32))):
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == _torch(
                np.asarray(w)).dtype
            np.testing.assert_array_equal(_np(g), _f32(w))


# ---------------------------------------------------------------------------
# the models: blocks, forward, prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_models_build_recurrent_blocks_without_an_mlp(arch):
    """init and params_from_jax: an ``rnn`` in place of ``attn`` on the
    recurrent layers, an MLP on attention layers only (reference
    ``transformer.py:127``), the reference's parameter count; a block
    kind the port does not know is refused."""
    jcfg, params, tcfg, model = _models(arch, "bfloat16")
    fresh = T.init(0, tcfg, device="cpu")
    for m in (model, fresh):
        assert [b.kind for b in m.blocks] == list(tcfg.pattern)
        for blk in m.blocks:
            attn = blk.kind.startswith("attn")
            assert (blk.attn is not None) == attn
            assert (blk.rnn is None) == attn
            assert (blk.mlp is not None) == (attn and tcfg.d_ff > 0)
        n = sum(p.numel() for p in m.parameters())
        assert n == sum(x.size for x in jax.tree.leaves(params))
    bad = dataclasses.replace(tcfg, layer_pattern=("lstm",) * tcfg.n_layers)
    with pytest.raises(ValueError, match="unknown block kinds"):
        T.init(0, bad, device="cpu")
    blk = model.blocks[0]
    period = JT.pattern_period(jcfg)
    for name, got in blk.rnn.items():
        want = np.asarray(params["blocks"][0]["rnn"][name][0])
        assert got.dtype == _torch(want).dtype
        np.testing.assert_array_equal(_np(got), want.astype(np.float32))
    assert period == len(tcfg.pattern)


MODES = [pytest.param("float32", 8, None, id="float32-S8"),
         pytest.param("float32", 512, "pallas", id="float32-S512-pallas"),
         pytest.param("float32", 512, None, id="float32-S512-ref"),
         pytest.param("bfloat16", 8, None, id="bfloat16-S8"),
         pytest.param("bfloat16", 512, None, id="bfloat16-S512-ref")]


@pytest.mark.parametrize("dtype,S,force", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match(monkeypatch, arch, dtype, S, force):
    """S = 8: the reference's forward against the port's forward and
    prefill.  S = 512: the reference's build_prefill_step (recurrentgemma's
    local attention through flash: the Pallas kernel in interpret mode or
    its jnp ref; xlstm's mLSTM in two chunks of 256) against the port's."""
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
        assert _rel_err(_np(full), _f32(want)) < TOL[dtype]
        want = want[:, -1:]
    else:
        want = jax_prefill(jcfg)(params, {"tokens": jnp.asarray(tokens)})
    assert _rel_err(_np(got), _f32(want)) < TOL[dtype]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches(arch, dtype):
    """The reference's decode loop and the port's, step by step over 40
    tokens; recurrentgemma's local-attention ring (window 32 in the smoke
    config) wraps.  The recurrent states after the last step too."""
    jcfg, params, tcfg, model = _models(arch, dtype)
    B, S = 2, 40
    tokens = _tokens(jcfg, B, S, seed=2)
    jcache, _ = JT.decode_init(jcfg, B, S + 4)
    tcache = T.decode_init(tcfg, B, S + 4, device="cpu")
    step = jax.jit(JT.decode_step, static_argnums=1)
    err = 0.0
    for t in range(S):
        want, jcache = step(params, jcfg, jnp.asarray(tokens[:, t:t + 1]),
                            jnp.int32(t), jcache)
        got, tcache = T.decode_step(model, tcfg,
                                    torch.from_numpy(tokens[:, t:t + 1]), t,
                                    tcache)
        err = max(err, _rel_err(_np(got), _f32(want)))
    assert err < TOL[dtype]
    period = JT.pattern_period(jcfg)
    for i, (kind, entry) in enumerate(zip(tcfg.pattern, tcache)):
        g, k = divmod(i, period)
        if kind.startswith("attn"):
            assert entry["kv"][0].shape[1] == min(S + 4, jcfg.window)
            continue
        want = jax.tree.map(lambda a: a[g], jcache[k]["state"])
        assert _tree_err(entry["state"], want) < TOL[dtype], kind


@pytest.mark.parametrize("arch,dtype,tol", [
    ("recurrentgemma-2b", "bfloat16", 3e-2), ("xlstm-1.3b", "float32", 1e-5),
    ("xlstm-1.3b", "bfloat16", 3e-2)])
def test_decode_matches_forward_within_the_port(monkeypatch, arch, dtype,
                                                tol):
    """Teacher-forced decode logits against forward logits, position by
    position.  xlstm's forward runs its mLSTM at chunk 1, the function
    decode computes (the reference's chunk deviation, module docstring)."""
    _, _, tcfg, model = _models(arch, dtype)
    B, S = 2, 16
    tokens = torch.from_numpy(_tokens(tcfg, B, S, seed=3))
    if arch == "xlstm-1.3b":
        _chunk_1(monkeypatch)
    full, _ = T.forward(model, tcfg, tokens, use_flash=False)
    cache = T.decode_init(tcfg, B, S + 4, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = T.decode_step(model, tcfg, tokens[:, t:t + 1], t,
                                      cache)
        outs.append(logits[:, 0])
    assert _rel_err(_np(torch.stack(outs, 1)), _np(full)) < tol


def test_the_reference_mlstm_decode_is_its_chunk_1_forward(monkeypatch):
    """The reference's own deviation, pinned: its decode loop equals its
    forward at chunk 1 (float32, 1e-5), while its default forward (one
    chunk of 16) is far from both (the within-chunk clamp)."""
    jcfg, params, _, _ = _models("xlstm-1.3b", "float32")
    B, S = 2, 16
    tokens = jnp.asarray(_tokens(jcfg, B, S, seed=4))
    default, _ = JT.forward(params, jcfg, tokens)
    cache, _ = JT.decode_init(jcfg, B, S)
    step = jax.jit(JT.decode_step, static_argnums=1)
    outs = []
    for t in range(S):
        logits, cache = step(params, jcfg, tokens[:, t:t + 1], jnp.int32(t),
                             cache)
        outs.append(_f32(logits[:, 0]))
    decode = np.stack(outs, 1)
    _chunk_1(monkeypatch)
    chunk_1, _ = JT.forward(params, jcfg, tokens)
    assert _rel_err(decode, _f32(chunk_1)) < 1e-5
    assert _rel_err(decode, _f32(default)) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_generate_matches_the_jax_serve_loop(arch):
    """The port's launcher loop on the CPU against a JAX build_serve_step
    loop on the same weights and prompt, fed the port's tokens: logits
    agree at every step, and each port token is the reference's argmax
    wherever the reference's top-2 margin exceeds the tolerance.
    recurrentgemma's 40-token prompt wraps its 32-slot ring."""
    jcfg, params, tcfg, model = _models(arch, "bfloat16")
    P, N = 40, 6
    prompt = launcher.make_prompt(tcfg, 2, P, device="cpu")
    ops.reset_launch_counts()
    res = launcher.generate(model, tcfg, prompt, N, keep_logits=True)
    assert not any(ops.launch_counts().values())
    assert res["tokens"].shape == (2, N) and res["tokens"].dtype == torch.int32
    jcache, _ = JT.decode_init(jcfg, 2, P + N + 1)
    step = jax.jit(jax_serve(jcfg))
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
def test_launcher_main_runs_a_recurrent_arch_on_the_cpu(capsys, arch):
    res = launcher.main(["--arch", arch, "--batch", "2", "--prompt-len", "5",
                         "--new-tokens", "3", "--device", "cpu"])
    assert res["tokens"].shape == (2, 3)
    assert f"{arch}: generated (2, 3) tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# training through the recurrent layers
# ---------------------------------------------------------------------------
def _batch(cfg, B, S, seed=0):
    b = JaxSyntheticLM(cfg.vocab, S, B, seed=seed).batch_at(3)
    b["labels"][0, : S // 4] = -1
    return b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch, dtype):
    jcfg, params, tcfg, model = _models(arch, dtype)
    b = _batch(tcfg, 2, 32)
    want = JT.loss_fn(params, jcfg, {k: jnp.asarray(v) for k, v in b.items()},
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
    b = _batch(tcfg, 2, 32, seed=2)
    return b, jax.jit(jax.grad(lambda p: JT.loss_fn(
        p, jcfg, {k: jnp.asarray(v) for k, v in b.items()},
        use_flash=False)))(params)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference_per_leaf(arch, remat):
    """Every leaf's gradient (through the scan, the mLSTM chunks and the
    sLSTM loop) against ``jax.grad``, per layer, float32."""
    jcfg, params, tcfg, _ = _models(arch, "float32")
    tcfg = dataclasses.replace(tcfg, remat=remat)
    model = _fresh_model(arch, "float32").requires_grad_(True)
    b, jgrads = _jax_grads(arch)
    T.loss_fn(model, tcfg, tstep.to_device(b, "cpu"),
              use_flash=False).backward()
    period = JT.pattern_period(jcfg)
    names = [n for n, _ in model.named_parameters()]
    assert any(".rnn." in n for n in names)
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            g, k = divmod(int(parts[1]), period)
            node = jgrads["blocks"][k]
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


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, name):
    """3 whole train steps of each smoke config at float32: losses and grad
    norms within 1e-4 relative.  The reference's optimizers see leaves
    stacked over layer groups (one group in both smoke configs), so its
    1-D leaves (the norms, RG-LRU's ``lambda_p``, the sLSTM ``norm``) are
    2-D there: its AdamW decays them and its Adafactor factors them, where
    the port's do neither (ROADMAP queue 3 b).  So after 3 AdamW steps the
    port's leaves of two or more dims (``conv_w`` among them) are held to
    the reference's within 1e-4 of a leaf's largest value, and the 1-D
    leaves within 1e-2.  Adafactor's leaves are held within 1e-2: RG-LRU's
    gate gradients are about 1e-12 (with random weights its decay ``a`` is
    near exp(-24)), so the factored second moment's row-times-column
    products fall below float32's normal range, where XLA on the CPU
    flushes to zero and torch keeps denormals; the floored entries then
    take normalised updates of another size (1.5e-3 of ``w_gate_a``'s
    largest value after 3 steps)."""
    jcfg, params, tcfg, _ = _models(arch, "float32")
    sched = dict(base_lr=1e-3, warmup=2, total=10)
    jo = jopt.make_optimizer(name, jopt.cosine_schedule(**sched))
    to = optim.make_optimizer(name, optim.cosine_schedule(**sched))
    jfn = jax.jit(jstep.build_train_step(jcfg, jo, use_flash=False))
    tfn = tstep.build_train_step(tcfg, to, use_flash=False)
    js = jstep.TrainState(params, jo.init(params), jnp.zeros((), jnp.int32))
    model = _fresh_model(arch, "float32").requires_grad_(True)
    ts = tstep.TrainState(model, to.init(dict(model.named_parameters())), 0)
    jdata = JaxSyntheticLM(tcfg.vocab, 32, 4, seed=5)
    tdata = SyntheticLM(tcfg.vocab, 32, 4, seed=5)
    for step in range(3):
        js, jm = jfn(js, {k: jnp.asarray(v)
                          for k, v in jdata.batch_at(step).items()})
        ts, tm = tfn(ts, tstep.to_device(tdata.batch_at(step), "cpu"))
        for key in ("loss", "grad_norm"):
            want = float(jm[key])
            assert abs(float(tm[key]) - want) <= 1e-4 * abs(want), (step, key)
    period = JT.pattern_period(jcfg)
    for layer, blk in enumerate(model.blocks):
        if blk.rnn is None:
            continue
        g, k = divmod(layer, period)
        for leaf, got in blk.rnn.items():
            want = np.asarray(js.params["blocks"][k]["rnn"][leaf][g])
            bar = 1e-4 if name == "adamw" and got.dim() >= 2 else 1e-2
            err = np.abs(got.detach().numpy() - want).max()
            assert err <= bar * np.abs(want).max(), (layer, leaf, err)
