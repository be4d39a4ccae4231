"""The port's training stack against the JAX reference, on the CPU.

Weights come from the reference's ``init`` and cross with
``params_from_jax``; batches come from numpy (the reference's
``SyntheticLM`` for JAX, the port's for torch, which must be bitwise the
same).  The reference trains with ``use_flash=False``, so neither side
reaches a flash kernel here.

Tolerances:

* ``loss_fn``: 1e-5 relative at float32 (the same casts; float32 sums in
  another order), 3e-2 at bf16 (``tests/test_models.py``'s bound: bf16
  matmul outputs round at the same places, but their float32 accumulation
  order differs and a one-ulp flip of a bf16 activation carries through the
  layers).
* gradients, per leaf at float32: within 1e-4 of the leaf's largest
  reference value (backward sums run in another order, and the reference
  scans layers where the port loops over them).
* ``AdamW.update`` and ``Adafactor.update`` on identical inputs over 3
  steps: 1e-6 (AdamW) and 1e-5 (Adafactor, whose rsqrt and means may
  differ by an ulp) relative, elementwise, with the same bound times the
  leaf's largest value as the absolute floor for entries near 0.
* ``cosine_schedule``: 3e-7 relative (numpy's float32 cos and XLA's may
  differ by an ulp), bitwise over the warm-up.
* ``clip_by_global_norm``: the norm 1e-6 relative (a float32 sum of
  squares in another order), the clipped bf16 gradients bitwise (one
  float32 product, rounded once).
* 3 whole train steps at float32: losses and grad norms within 1e-4
  relative.  The reference's layer-stacked norm vectors are 2-D, so its
  AdamW decays them where the port's does not (their weights start at 0
  and move by about lr: a 1e-8 effect on the loss).
* ``SyntheticLM`` and ``auto_microbatches``: equal.
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
from repro.kernels.ref import flash_attention_ref  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import all_arch_ids, get_config  # noqa: E402
from repro_torch.data import DataState, SyntheticLM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCHS = ["chatglm3-6b", "gemma2-9b", "h2o-danube-3-4b"]
LOSS_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _rel(got, want) -> float:
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-12)


@functools.lru_cache(maxsize=None)
def _jax_models(arch: str, dtype: str):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    params, _ = JT.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, tcfg


def _port_model(arch: str, dtype: str):
    """A fresh port model (gradients on) holding the reference's weights."""
    _, params, tcfg = _jax_models(arch, dtype)
    model = T.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return model.requires_grad_(True)


def _batch(cfg, B, S, seed=0):
    """A SyntheticLM batch with a few more labels masked."""
    b = JaxSyntheticLM(cfg.vocab, S, B, seed=seed).batch_at(3)
    b["labels"][0, : S // 4] = -1
    return b


def _torch_batch(b):
    return tstep.to_device(b, "cpu")


def _jax_leaf(tree, name: str, period: int):
    """The reference's leaf for the port's parameter ``name``."""
    parts = name.split(".")
    if parts[0] != "blocks":
        node = tree
        for p in parts:
            node = node[p]
        return np.asarray(node)
    g, k = divmod(int(parts[1]), period)
    node = tree["blocks"][k]
    for p in parts[2:]:
        node = node[p]
    return np.asarray(node[g])


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_matches_reference(arch, dtype):
    jcfg, params, tcfg = _jax_models(arch, dtype)
    model = _port_model(arch, dtype)
    b = _batch(tcfg, 2, 32)
    want = JT.loss_fn(params, jcfg, {k: jnp.asarray(v) for k, v in b.items()},
                      use_flash=False)
    with torch.no_grad():
        got = T.loss_fn(model, tcfg, _torch_batch(b), use_flash=False)
    assert got.dtype == torch.float32 and got.shape == ()
    assert _rel(got, want) <= LOSS_TOL[dtype]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_chunked_matches_reference_and_whole(arch):
    jcfg, params, tcfg = _jax_models(arch, "float32")
    model = _port_model(arch, "float32")
    b = _batch(tcfg, 2, 32, seed=4)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = JT.loss_fn(params, jcfg, jb, use_flash=False, seq_chunk=16)
    with torch.no_grad():
        got = T.loss_fn(model, tcfg, _torch_batch(b), use_flash=False,
                        seq_chunk=16)
        whole = T.loss_fn(model, tcfg, _torch_batch(b), use_flash=False)
    assert _rel(got, want) <= LOSS_TOL["float32"]
    assert _rel(got, whole) <= LOSS_TOL["float32"]


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference_per_leaf(arch):
    jcfg, params, tcfg = _jax_models(arch, "float32")
    model = _port_model(arch, "float32")
    b = _batch(tcfg, 2, 32, seed=2)
    jgrads = jax.grad(lambda p: JT.loss_fn(
        p, jcfg, {k: jnp.asarray(v) for k, v in b.items()},
        use_flash=False))(params)
    T.loss_fn(model, tcfg, _torch_batch(b), use_flash=False).backward()
    period = JT.pattern_period(jcfg)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == sum(
        np.asarray(x).shape[0] if path[0].key == "blocks" else 1
        for path, x in jax.tree_util.tree_leaves_with_path(jgrads))
    for name, p in model.named_parameters():
        want = _jax_leaf(jgrads, name, period)
        got = p.grad.numpy()
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name


def test_remat_gives_the_same_gradients():
    _, _, tcfg = _jax_models("gemma2-9b", "float32")
    b = _torch_batch(_batch(tcfg, 2, 32))
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        model = _port_model("gemma2-9b", "float32")
        T.loss_fn(model, cfg, b, use_flash=False).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


def test_flash_plain_version_is_differentiable_like_the_reference():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(1, 40, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, 40, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, 40, 2, 16)).astype(np.float32)
    w = rng.normal(size=(1, 40, 4, 16)).astype(np.float32)
    jg = jax.grad(lambda q_, k_, v_: jnp.sum(flash_attention_ref(
        q_, k_, v_, causal=True, logit_softcap=20.0, block_kv=16) * w),
        argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True, logit_softcap=20.0)
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_flash_kernel_refuses_a_gradient(monkeypatch):
    """The dispatch's guard: where the kernel would run (a card; here the
    dispatch is made to pick it for CPU tensors), a call whose gradient
    autograd would need raises before any launch."""
    monkeypatch.setattr(ops, "_use_kernel", lambda t: True)
    monkeypatch.setattr(ops.fak, "flash_attention", lambda *a, **k: (
        pytest.fail("the kernel was called")))
    q = torch.zeros((1, 8, 2, 16), requires_grad=True)
    kv = torch.zeros((1, 8, 2, 16))
    with pytest.raises(NotImplementedError, match="use_flash=False"):
        ops.flash_attention(q, kv, kv)
    ok = []
    monkeypatch.setattr(ops.fak, "flash_attention",
                        lambda *a, **k: ok.append(1))
    with torch.no_grad():
        ops.flash_attention(q, kv, kv)
    ops.flash_attention(q.detach(), kv, kv)
    assert ok == [1, 1]


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
SHAPES = {"w": (8, 16), "stack": (3, 4, 5), "bias": (16,), "scalar": (1,)}


def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-3, 1)
                  ).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]
    return params, grads


def _assert_leaf_close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name,rtol,moments", [
    ("adamw", 1e-6, ("m", "v")), ("adafactor", 1e-5, ("vr", "vc"))])
def test_optimizer_updates_match_reference(name, rtol, moments):
    params, grads = _opt_inputs(7)
    jo = jopt.make_optimizer(name, jopt.cosine_schedule(1e-2, 2, 10),
                             weight_decay=0.1)
    to = optim.make_optimizer(name, optim.cosine_schedule(1e-2, 2, 10),
                              weight_decay=0.1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jo.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = to.init(tp)
    for g in grads:
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
        out, ts = to.update(tg, ts, tp)
        assert out is tp
        for k in SHAPES:   # the gradients are left as they were given
            assert np.array_equal(tg[k].numpy(), g[k])
    assert ts.step == int(js.step) == 3
    for k in SHAPES:
        _assert_leaf_close(tp[k].numpy(), jp[k], rtol)
        for mom in moments:
            _assert_leaf_close(getattr(ts, mom)[k].numpy(),
                               getattr(js, mom)[k], rtol)


def test_cosine_schedule_matches_reference():
    jl = jopt.cosine_schedule(3e-4, 7, 50)
    tl = optim.cosine_schedule(3e-4, 7, 50)
    for s in range(0, 60):   # numpy's and XLA's cos may differ by an ulp
        assert _rel(tl(s), jl(s)) <= 3e-7, s
        if s <= 7:           # the warm-up has no cos: bitwise
            assert np.float32(tl(s)) == np.float32(jl(s)), s


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    f32 = rng.normal(size=(5, 7)).astype(np.float32) * 3
    bf = rng.normal(size=(64,)).astype(np.float32)
    for max_norm in (1.0, 1e3):
        jg, jn = jopt.clip_by_global_norm(
            {"a": jnp.asarray(f32), "b": jnp.asarray(bf, jnp.bfloat16)},
            max_norm)
        tg, tn = optim.clip_by_global_norm(
            {"a": torch.from_numpy(f32.copy()),
             "b": torch.from_numpy(bf).to(torch.bfloat16)}, max_norm)
        assert _rel(tn, jn) <= 1e-6
        np.testing.assert_allclose(tg["a"].numpy(), np.asarray(jg["a"]),
                                   rtol=1e-6, atol=0)
        assert tg["b"].dtype == torch.bfloat16
        assert np.array_equal(tg["b"].float().numpy(),
                              np.asarray(jg["b"].astype(jnp.float32)))


def test_ef_compress_round_trip_matches_reference():
    rng = np.random.default_rng(2)
    g = rng.normal(size=(33, 17)).astype(np.float32)
    res = rng.normal(size=(33, 17)).astype(np.float32) * 1e-3
    jq, js, jr = jopt.ef_compress(jnp.asarray(g), jnp.asarray(res))
    tq, ts, tr = optim.ef_compress(torch.from_numpy(g), torch.from_numpy(res))
    assert tq.dtype == torch.int8
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(optim.ef_decompress(tq, ts).numpy(),
                                  np.asarray(jopt.ef_decompress(jq, js)))


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_match_reference(arch, n_micro):
    jcfg, params, tcfg = _jax_models(arch, "float32")
    sched = dict(base_lr=1e-3, warmup=2, total=10)
    jo = jopt.AdamW(lr=jopt.cosine_schedule(**sched))
    to = optim.AdamW(lr=optim.cosine_schedule(**sched))
    jfn = jax.jit(jstep.build_train_step(jcfg, jo, n_micro=n_micro,
                                         use_flash=False))
    tfn = tstep.build_train_step(tcfg, to, n_micro=n_micro, use_flash=False)
    js = jstep.TrainState(params, jo.init(params), jnp.zeros((), jnp.int32))
    model = _port_model(arch, "float32")
    ts = tstep.TrainState(model, to.init(dict(model.named_parameters())), 0)
    jdata = JaxSyntheticLM(tcfg.vocab, 32, 4, seed=5)
    tdata = SyntheticLM(tcfg.vocab, 32, 4, seed=5)
    for step in range(3):
        js, jm = jfn(js, {k: jnp.asarray(v)
                          for k, v in jdata.batch_at(step).items()})
        ts, tm = tfn(ts, tstep.to_device(tdata.batch_at(step), "cpu"))
        assert tm["step"] == int(jm["step"]) == step + 1
        assert _rel(tm["loss"], jm["loss"]) <= 1e-4, step
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-4, step
    assert ts.opt_state.step == 3
    assert all(p.grad is None for p in model.parameters())


def test_make_state_turns_gradients_on():
    cfg = get_config("chatglm3-6b", smoke=True)
    st = tstep.make_state(0, cfg, optim.AdamW(), device="cpu")
    assert all(p.requires_grad for p in st.params.parameters())
    assert st.step == 0 and st.opt_state.step == 0
    m = st.opt_state.m
    assert m.keys() == dict(st.params.named_parameters()).keys()
    assert all(t.dtype == torch.float32 and not t.any() for t in m.values())


# ---------------------------------------------------------------------------
# data pipeline and microbatching
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra", [None, (4, 3, 5)])
def test_synthetic_lm_batches_bitwise_equal(extra):
    jd = JaxSyntheticLM(300, 40, 4, seed=9, extra_shape=extra)
    td = SyntheticLM(300, 40, 4, seed=9, extra_shape=extra)
    for step in (0, 1, 17):
        for lo, hi in ((0, None), (1, 3)):
            a, b = jd.batch_at(step, lo, hi), td.batch_at(step, lo, hi)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    it = td.iterate(DataState(seed=9, step=2))
    for want in (2, 3):
        step, batch = next(it)
        assert step == want
        assert np.array_equal(batch["tokens"], jd.batch_at(want)["tokens"])
    it.close()


def test_auto_microbatches_equal_reference():
    for arch in all_arch_ids():
        for full in (False, True):
            tcfg = get_config(arch, smoke=not full)
            jcfg = jax_config(arch, smoke=not full)
            for gb, seq, dp in ((8, 128, 1), (256, 4096, 16), (64, 8192, 4),
                                (4, 512, 1), (96, 32768, 8)):
                assert tstep.auto_microbatches(tcfg, gb, seq, dp) == \
                    jstep.auto_microbatches(jcfg, gb, seq, dp)


def test_plain_flash_stays_the_cpu_path():
    q = torch.zeros((1, 8, 2, 16))
    assert torch.equal(ops.flash_attention(q, q, q),
                       kref.flash_attention_plain(q, q, q))
