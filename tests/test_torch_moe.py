"""The port's mixture-of-experts layers against the JAX reference, on the
CPU: ``moe_apply`` alone, then the granite-moe-1b-a400m and kimi-k2-1t-a32b
smoke configs through forward, prefill, decode, ``loss_fn`` and its
gradients.

Weights come from the reference's ``init`` / ``moe_init`` and cross with
``params_from_jax``; inputs come from numpy.  The reference's flash path
runs as ``tests/test_torch_lm.py`` runs it (``FORCE = "pallas"``, the
Pallas kernel in interpret mode, or ``None``, its jnp ref).

Routing is compared through both sides' own decisions: the reference's
are read inside ``jax.lax.top_k`` (an ordered debug callback, one record
per MoE layer call), the port's inside ``layers.moe_route``.

Tolerances:

* gate indices: bitwise wherever both sides route the same input (every
  ``moe_apply`` case, and every layer of the float32 models).  In the bf16
  models the layers' inputs differ by bf16 ulps (the attention's bf16
  products round after float32 sums in another order, as
  ``tests/test_torch_lm.py`` states), and an ulp can reorder two router
  probabilities that are nearly tied.  So the bf16 models run routed as
  the reference routed (the port's ``moe_route`` takes the reference's
  indices and gathers its own gate values), which keeps every layer's
  input within rounding of the reference's; each router's own choice
  must then equal the reference's but where the reference's
  probabilities of the experts it swaps are within ``NEAR_TIE``
  (relative) of each other.
* outputs and logits: 1e-5 (float32) and 3e-2 (bf16) of the largest
  reference value, ``tests/test_torch_lm.py``'s bars;
* the aux loss: 1e-6 relative (float32 means over the same values);
* ``loss_fn`` and per-leaf gradients: ``tests/test_torch_train.py``'s
  (1e-5 / 3e-2 on the loss, 1e-4 of the leaf's largest value on a
  gradient).
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
from repro.train import step as jstep  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.step import build_prefill_step  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
#: two router probabilities closer than this (relative) are a near tie,
#: which a bf16 ulp of the layer input may reorder: 2**-7, two bf16 ulps
NEAR_TIE = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MOE_ROUTE = L.moe_route


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tparams(params, dtype):
    """The reference's MoE leaves as tensors: the router stays float32."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k == "router" else DTYPES[dtype][1])
        for k, v in params.items()}


# ---------------------------------------------------------------------------
# routing records
# ---------------------------------------------------------------------------
def record_jax_routing(monkeypatch):
    """Each reference call of ``jax.lax.top_k`` appends (probs, indices)."""
    seen = []
    top_k = jax.lax.top_k

    def recording(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(
            lambda p, i: seen.append((np.asarray(p), np.asarray(i))),
            x, idx, ordered=True)
        return vals, idx
    monkeypatch.setattr(jax.lax, "top_k", recording)
    return seen


def record_port_routing(monkeypatch, pinned=None):
    """Each port call of ``moe_route`` appends (probs, indices); with
    ``pinned`` (the reference's records, in call order) the port routes to
    the reference's experts and gathers its own gate values for them,
    while the record keeps the experts it would have chosen."""
    seen = []
    feed = iter(pinned) if pinned is not None else None

    def recording(router, xf, top_k):
        probs, vals, idx = MOE_ROUTE(router, xf, top_k)
        seen.append((_np(probs), idx.numpy().copy()))
        if feed is not None:
            idx = torch.from_numpy(next(feed)[1].astype(np.int64)).reshape(
                idx.shape)
            vals = torch.gather(probs, -1, idx)
            vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
        return probs, vals, idx
    monkeypatch.setattr(L, "moe_route", recording)
    return seen


def check_routing(ref, port, dtype):
    """Bitwise in float32; in bf16 a token's indices differ only at a near
    tie of the reference's probabilities.  Returns the differing tokens."""
    assert len(ref) == len(port) > 0
    flips = 0
    for (rp, ri), (_, pi) in zip(ref, port):
        rp, ri = rp.reshape(-1, rp.shape[-1]), ri.reshape(pi.shape)
        differ = (ri != pi).any(-1)
        if dtype == "float32":
            assert not differ.any()
            continue
        for t in np.flatnonzero(differ):
            moved = ri[t] != pi[t]
            p = rp[t][np.concatenate([ri[t][moved], pi[t][moved]])]
            assert (p.max() - p.min()) / p.max() < NEAR_TIE, (t, rp[t])
        flips += int(differ.sum())
    return flips


# ---------------------------------------------------------------------------
# moe_apply alone
# ---------------------------------------------------------------------------
def _jax_keep(gate_idx, E, C):
    """The reference's dispatch (``layers.py:310-316``): a stable argsort
    of the slot experts, then each sorted slot's position from a one-hot
    cumsum; returned in slot order."""
    slot_expert = jnp.asarray(gate_idx).reshape(-1)
    order = jnp.argsort(slot_expert)
    sorted_expert = slot_expert[order]
    same = jnp.cumsum(jax.nn.one_hot(sorted_expert, E, dtype=jnp.int32), 0)
    pos_sorted = same[jnp.arange(slot_expert.shape[0]), sorted_expert] - 1
    pos = np.empty(slot_expert.shape[0], np.int64)
    pos[np.asarray(order)] = np.asarray(pos_sorted)
    return pos, pos < C


def _moe_case(T_, E, k, dtype, bias=0.0, zero_rows=0, seed=0):
    params, _ = JL.moe_init(jax.random.PRNGKey(seed), 16, 32, E,
                            DTYPES[dtype][0])
    params = dict(params)
    if bias:   # favour expert 0 so that it overflows its capacity
        params["router"] = params["router"].at[:, 0].add(bias)
    x = np.random.default_rng(seed).normal(size=(2, T_ // 2, 16))
    x[:, :zero_rows] = 0.0
    return params, x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T_,E,k,bias,dropped", [
    pytest.param(64, 4, 2, 0.0, False, id="dropless"),
    pytest.param(4096, 8, 2, 0.5, True, id="capacity"),
    pytest.param(1024, 8, 8, 0.0, False, id="dropless-k-eq-E"),
])
def test_moe_apply_matches_reference(dtype, T_, E, k, bias, dropped):
    params, x = _moe_case(T_, E, k, dtype, bias)
    jx = jnp.asarray(x, DTYPES[dtype][0])
    want, want_aux = JL.moe_apply(params, jx, E, k)
    tx = torch.from_numpy(x).to(DTYPES[dtype][1])
    tp = _tparams(params, dtype)
    got, aux = L.moe_apply(tp, tx, E, k)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert _rel_err(_np(got), _f32(want)) < TOL[dtype]
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    # gate indices bitwise on the same input; the dropped slots the same
    xf = tx.reshape(-1, 16)
    probs, gate_vals, gate_idx = L.moe_route(tp["router"], xf, k)
    jprobs = jax.nn.softmax(jnp.asarray(jx.reshape(-1, 16), jnp.float32)
                            @ params["router"], axis=-1)
    jvals, jidx = jax.lax.top_k(jprobs, k)
    assert np.array_equal(gate_idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate_vals.numpy(), np.asarray(
        jvals / jnp.maximum(jvals.sum(-1, keepdims=True), 1e-9)),
        rtol=TOL["float32"])
    C = L.moe_capacity(T_, k, E)
    assert C == (T_ * k if T_ * k <= 4096 else int(T_ * k * 1.25 / E))
    rows, keep = L.moe_dispatch(gate_idx, E, C)
    pos, jkeep = _jax_keep(jidx, E, C)
    assert np.array_equal(keep.numpy(), jkeep)
    assert np.array_equal(rows.numpy()[jkeep],
                          (np.asarray(jidx).reshape(-1) * C + pos)[jkeep])
    assert bool((~keep).any()) == dropped
    if dropped:   # a dropped slot adds nothing: its token's sum lacks it
        assert int((~keep).sum()) > 100


def test_moe_route_breaks_ties_by_lower_index():
    """Zero rows give uniform probabilities: the first k experts, as
    ``jax.lax.top_k`` takes them."""
    params, x = _moe_case(64, 8, 3, "float32", zero_rows=5)
    xf = torch.from_numpy(x.reshape(-1, 16))
    _, vals, idx = L.moe_route(torch.from_numpy(np.array(params["router"])),
                               xf, 3)
    _, jidx = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x.reshape(-1, 16)) @ params["router"], axis=-1), 3)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    tied = idx.reshape(2, 32, 3)[:, :5]
    assert (tied == torch.tensor([0, 1, 2])).all()
    assert torch.allclose(vals.reshape(2, 32, 3)[:, :5], torch.tensor(1 / 3))


@pytest.mark.parametrize("T_,E,k,C", [(50, 4, 2, 100), (300, 6, 3, 80),
                                      (7, 5, 5, 1)])
def test_moe_dispatch_positions_match_the_one_hot_cumsum(T_, E, k, C):
    rng = np.random.default_rng(T_)
    gate_idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T_)])
    rows, keep = L.moe_dispatch(torch.from_numpy(gate_idx), E, C)
    pos, jkeep = _jax_keep(gate_idx, E, C)
    assert np.array_equal(keep.numpy(), jkeep)
    assert np.array_equal(rows.numpy(), np.where(
        jkeep, gate_idx.reshape(-1) * C + pos, gate_idx.reshape(-1) * C))
    # each kept slot has its own row of the (E * C) buffer
    assert len(set(rows.numpy()[jkeep].tolist())) == int(jkeep.sum())


def test_moe_init_makes_a_float32_router_and_bf16_experts():
    gen = torch.Generator().manual_seed(0)
    p = L.moe_init(gen, 16, 24, 6, torch.bfloat16, "cpu")
    assert p["router"].dtype == torch.float32 and p["router"].shape == (16, 6)
    assert p["w_gate"].shape == p["w_up"].shape == (6, 16, 24)
    assert p["w_down"].shape == (6, 24, 16)
    assert all(p[k].dtype == torch.bfloat16 for k in ("w_gate", "w_up",
                                                      "w_down"))
    assert float(p["w_gate"].float().abs().max()) <= 0.25
    assert float(p["w_down"].float().abs().max()) <= 24 ** -0.5
    jp, _ = JL.moe_init(jax.random.PRNGKey(0), 16, 24, 6)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


def test_moe_apply_keeps_its_gradient_paths():
    """Router, experts and input all get gradients, as under jax.grad."""
    params, x = _moe_case(64, 4, 2, "float32")
    tp = {k: v.requires_grad_(True) for k, v in
          _tparams(params, "float32").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    w = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = JL.moe_apply(p, xx, 4, 2)
        return jnp.sum(y * w) + aux
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    y, aux = L.moe_apply(tp, tx, 4, 2)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    for k in tp:
        want = np.asarray(jg[k])
        assert np.abs(tp[k].grad.numpy() - want).max() <= \
            1e-5 * np.abs(want).max(), k
    assert np.abs(tx.grad.numpy() - np.asarray(jgx)).max() <= \
        1e-5 * np.abs(np.asarray(jgx)).max()


# ---------------------------------------------------------------------------
# the MoE models: forward, prefill, decode
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _models(arch: str, dtype: str):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    params, _ = JT.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, tcfg


def _port_model(arch, dtype):
    _, params, tcfg = _models(arch, dtype)
    return T.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                             device="cpu")


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _run_port(monkeypatch, dtype, ref_routes, fn):
    """``fn()`` on the port, its routing checked against ``ref_routes``:
    routed freely in float32, as the reference routed in bf16.  Returns
    fn's result and the count of tokens whose own choice differed."""
    routes = record_port_routing(
        monkeypatch, pinned=ref_routes if dtype == "bfloat16" else None)
    out = fn()
    return out, check_routing(ref_routes, routes, dtype)


def test_params_from_jax_carries_the_moe_leaves():
    jcfg, params, tcfg = _models("kimi-k2-1t-a32b", "bfloat16")
    model = _port_model("kimi-k2-1t-a32b", "bfloat16")
    for i, blk in enumerate(model.blocks):
        assert blk.mlp is None and set(blk.moe) == {
            "router", "w_gate", "w_up", "w_down"}
        for k, v in blk.moe.items():
            want = np.asarray(params["blocks"][0]["moe"][k][i])
            got = v.detach()
            assert got.dtype == (torch.float32 if k == "router"
                                 else torch.bfloat16)
            bits = got.view(torch.int32 if k == "router" else torch.int16)
            assert np.array_equal(bits.numpy(), want.view(bits.numpy().dtype))
    init = T.init(0, tcfg, device="cpu")
    assert [n for n, _ in init.named_parameters()] == \
        [n for n, _ in model.named_parameters()]
    assert sum(p.numel() for p in init.parameters()) == sum(
        x.size for x in jax.tree.leaves(params))


MODES = [pytest.param("float32", 8, None, id="float32-sdpa-S8"),
         pytest.param("float32", 512, "pallas",
                      id="float32-flash-S512-pallas"),
         pytest.param("float32", 512, None, id="float32-flash-S512-ref"),
         pytest.param("bfloat16", 8, None, id="bfloat16-sdpa-S8"),
         pytest.param("bfloat16", 512, None, id="bfloat16-flash-S512-ref")]


@pytest.mark.parametrize("dtype,S,force", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match(monkeypatch, arch, dtype, S, force):
    """S = 8: the reference's forward (logits and aux) against the port's
    forward and prefill.  S = 512: the reference's build_prefill_step
    (flash through the Pallas kernel in interpret mode or its jnp ref)
    against the port's; B = 1 keeps S = 512 dropless (1,024 slots)."""
    jcfg, params, tcfg = _models(arch, dtype)
    model = _port_model(arch, dtype)
    B = 2 if S == 8 else 1
    tokens = _tokens(jcfg, B, S)
    monkeypatch.setattr(jax_ops, "FORCE", force)
    ref_routes = record_jax_routing(monkeypatch)
    if S == 8:
        want, want_aux = JT.forward(params, jcfg, jnp.asarray(tokens))
    else:
        want = jax_prefill(jcfg)(params, {"tokens": jnp.asarray(tokens)})
    jax.effects_barrier()
    assert len(ref_routes) == jcfg.n_layers
    tt = torch.from_numpy(tokens)
    if S == 8:
        (full, aux), _ = _run_port(monkeypatch, dtype, ref_routes,
                                   lambda: T.forward(model, tcfg, tt))
        assert full.shape == (B, S, tcfg.padded_vocab)
        assert _rel_err(_np(full), _f32(want)) < TOL[dtype]
        assert abs(float(aux) - float(want_aux)) <= \
            TOL[dtype] / 10 * abs(float(want_aux))
        want = want[:, -1:]
    prefill = build_prefill_step(tcfg)
    got, _ = _run_port(monkeypatch, dtype, ref_routes,
                       lambda: prefill(model, {"tokens": tt}))
    assert got.shape == (B, 1, tcfg.padded_vocab)
    assert _rel_err(_np(got), _f32(want)) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches(monkeypatch, arch, dtype):
    """The reference's decode loop and the port's, step by step; each step
    routes B = 2 tokens per layer (dropless)."""
    jcfg, params, tcfg = _models(arch, dtype)
    model = _port_model(arch, dtype)
    B, S = 2, 24
    tokens = _tokens(jcfg, B, S, seed=2)
    jcache, _ = JT.decode_init(jcfg, B, S)
    jstep_fn = jax.jit(JT.decode_step, static_argnums=1)
    ref_routes = record_jax_routing(monkeypatch)
    want = []
    for t in range(S):
        logits, jcache = jstep_fn(params, jcfg,
                                  jnp.asarray(tokens[:, t:t + 1]),
                                  jnp.int32(t), jcache)
        want.append(_f32(logits))
    jax.effects_barrier()
    assert len(ref_routes) == S * jcfg.n_layers

    def port_loop():
        cache = T.decode_init(tcfg, B, S, device="cpu")
        out = []
        for t in range(S):
            logits, cache = T.decode_step(
                model, tcfg, torch.from_numpy(tokens[:, t:t + 1]), t, cache)
            out.append(_np(logits))
        return out
    got, _ = _run_port(monkeypatch, dtype, ref_routes, port_loop)
    assert _rel_err(np.stack(got), np.stack(want)) < TOL[dtype]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_within_the_port(arch):
    """Teacher-forced decode logits equal forward logits position by
    position (float32: the same routing on the same tokens)."""
    tcfg = _models(arch, "float32")[2]
    model = _port_model(arch, "float32")
    B, S = 2, 8
    tokens = torch.from_numpy(_tokens(tcfg, B, S, seed=3))
    full, _ = T.forward(model, tcfg, tokens, use_flash=False)
    cache = T.decode_init(tcfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = T.decode_step(model, tcfg, tokens[:, t:t + 1], t,
                                      cache)
        outs.append(logits[:, 0])
    assert _rel_err(_np(torch.stack(outs, 1)), _np(full)) < 1e-5


def test_launcher_main_runs_a_moe_arch_on_the_cpu(capsys):
    res = launcher.main(["--arch", "granite-moe-1b-a400m", "--batch", "2",
                         "--prompt-len", "5", "--new-tokens", "3",
                         "--device", "cpu"])
    assert res["tokens"].shape == (2, 3)
    assert "granite-moe-1b-a400m: generated (2, 3) tokens" in \
        capsys.readouterr().out


# ---------------------------------------------------------------------------
# training through the MoE layers
# ---------------------------------------------------------------------------
def _batch(cfg, B, S, seed=0):
    b = JaxSyntheticLM(cfg.vocab, S, B, seed=seed).batch_at(3)
    b["labels"][0, : S // 4] = -1
    return b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_with_aux_matches_reference(monkeypatch, arch, dtype):
    jcfg, params, tcfg = _models(arch, dtype)
    model = _port_model(arch, dtype)
    b = _batch(tcfg, 2, 32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = tstep.to_device(b, "cpu")
    with torch.no_grad():
        _, aux = T.hidden_forward(model, tcfg, tb["tokens"], use_flash=False)
    assert float(aux) > 1.0     # each layer's balance loss is about 1
    ref_routes = record_jax_routing(monkeypatch)
    want = JT.loss_fn(params, jcfg, jb, use_flash=False)
    jax.effects_barrier()
    with torch.no_grad():
        got, _ = _run_port(monkeypatch, dtype, ref_routes, lambda: T.loss_fn(
            model, tcfg, tb, use_flash=False))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) <= TOL[dtype] * abs(float(want))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference_per_leaf(arch, remat):
    """Router and expert gradients (through the gate values, the aux loss
    and the dispatch's index ops) against ``jax.grad``, per layer."""
    jcfg, params, tcfg = _models(arch, "float32")
    tcfg = dataclasses.replace(tcfg, remat=remat)
    model = _port_model(arch, "float32").requires_grad_(True)
    b = _batch(tcfg, 2, 32, seed=2)
    jgrads = jax.grad(lambda p: JT.loss_fn(
        p, jcfg, {k: jnp.asarray(v) for k, v in b.items()},
        use_flash=False))(params)
    T.loss_fn(model, tcfg, tstep.to_device(b, "cpu"),
              use_flash=False).backward()
    names = [n for n, _ in model.named_parameters()]
    assert sum(".moe." in n for n in names) == 4 * tcfg.n_layers
    assert JT.pattern_period(jcfg) == 1     # blocks[0] stacks every layer
    for name, p in model.named_parameters():
        parts = name.split(".")
        node = jgrads
        if parts[0] == "blocks":
            node = jgrads["blocks"][0]
            for q in parts[2:]:
                node = node[q]
            want = np.asarray(node[int(parts[1])])
        else:
            for q in parts:
                node = node[q]
            want = np.asarray(node)
        got = p.grad.numpy()
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_steps_match_reference(name):
    """3 whole train steps of granite's smoke config at float32: losses and
    grad norms within 1e-4 relative (``tests/test_torch_train.py``'s bar).
    The reference's optimizers see layer-stacked expert leaves (L, E, d,
    f) where the port's are per layer (E, d, f).  AdamW is elementwise, so
    that changes nothing; Adafactor factors each (layer, expert) slice the
    same way, but the reference clips the update's RMS over the whole
    stack, so its expert weights drift apart, within 1e-2 of a leaf's
    largest value over these steps (ROADMAP queue 3 b)."""
    jcfg, params, tcfg = _models("granite-moe-1b-a400m", "float32")
    sched = dict(base_lr=1e-3, warmup=2, total=10)
    jo = jopt.make_optimizer(name, jopt.cosine_schedule(**sched))
    to = optim.make_optimizer(name, optim.cosine_schedule(**sched))
    jfn = jax.jit(jstep.build_train_step(jcfg, jo, use_flash=False))
    tfn = tstep.build_train_step(tcfg, to, use_flash=False)
    js = jstep.TrainState(params, jo.init(params), jnp.zeros((), jnp.int32))
    model = _port_model("granite-moe-1b-a400m", "float32").requires_grad_(
        True)
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
    # the MoE leaves after 3 steps: AdamW's within 1e-4 of a leaf's
    # largest value; Adafactor's drift (the stack-wide RMS clip) stays
    # within 1e-2
    bar = {"adamw": 1e-4, "adafactor": 1e-2}[name]
    for layer, blk in enumerate(model.blocks):
        for leaf, got in blk.moe.items():
            want = np.asarray(js.params["blocks"][0]["moe"][leaf][layer])
            err = np.abs(got.detach().numpy() - want).max()
            assert err <= bar * np.abs(want).max(), (layer, leaf, err)
