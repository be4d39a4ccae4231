"""Shared shape of the port's mesh tests (``tests/test_torch_mesh*.py``):
the reference's stacked specs mapped onto the port's per-layer parameter
names, a spawned gloo world on the CPU, and the train runs both sides
compare."""

import dataclasses
import socket
import traceback

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.registry import make_batch

#: archs the 4-rank tests train: dense, MoE, recurrent, encoder-decoder
RANK_ARCHS = ("chatglm3-6b", "granite-moe-1b-a400m", "recurrentgemma-2b",
              "whisper-base")
#: (data, model) meshes over 4 ranks
RANK_MESHES = ((2, 2), (4, 1), (1, 4))
#: (mesh, sequence parallelism) cases: every mesh plain, and the meshes
#: with a "model" axis under ``ACTIVATION_SPEC`` ("data", "model", None)
RANK_CASES = tuple((m, False) for m in RANK_MESHES) + \
    tuple((m, True) for m in RANK_MESHES if m[1] > 1)
SP_SPEC = ("data", "model", None)
WORLD = 4
STEPS = 2
BATCH, SEQ = 4, 16
#: float32 sharded against single-process (sums over ranks in another
#: order): losses and grad norms (AdamW's update does not see a gradient's
#: scale, the norm does), and serving's logits relative to the step's
#: largest
RANK_TOL = 1e-5
#: the optimizer's moments (AdamW's m and v) and factors (Adafactor's vr
#: and vc), leaf by leaf, relative to the leaf's largest element.  The
#: largest seen is 1.4e-5, in whisper-base's cross-layer norms, whose
#: gradients pass through the cross gate (0 at init, about lr after the
#: first step) and are the sum's rounding of larger terms
MOMENT_TOL = 1e-4
#: each parameter after the steps, in units of the steps' summed learning
#: rate, where both steps' reference gradients stand above rounding
#: (:data:`GRAD_FLOOR`): an update that is zero, of the wrong sign or
#: applied to the wrong shard errs by about 1.  The largest seen is
#: 1.3e-4, a float32 ulp of a parameter near 1
UPDATE_TOL_LR = 1e-3
#: a gradient element "zero to rounding": below this share of its leaf's
#: largest, sums in another order move its AdamW update (m / sqrt(v),
#: about +-1 whatever the gradient's size) by more than rounding
GRAD_FLOOR = 1e-2
#: the steps' learning rates (``cosine_schedule(3e-4, 2, 10)``)
LRS = (1.5e-4, 3e-4)
#: the optimizers the 4-rank world trains with: AdamW on every case,
#: Adafactor (kimi-k2-1t-a32b's, by the launcher's rule) on every mesh
#: without sequence parallelism
TRAIN_CASES = tuple((m, sp, "adamw") for m, sp in RANK_CASES) + \
    tuple((m, False, "adafactor") for m in RANK_MESHES)
#: the served cases: (arch, the window it is cut to), the prompt's
#: length, the teacher-forced decode steps and the cache's length.
#: gemma2-9b's ring of 6 slots splits over "model" at (2, 2) and is
#: replicated at (1, 4), where 6 does not divide; recurrentgemma-2b's ring
#: of 8 splits at both, beside its RG-LRU state; whisper-base primes its
#: cross K/V from the encoder
SERVE_ARCHS = (("gemma2-9b", 6), ("recurrentgemma-2b", 8),
               ("whisper-base", None))
SERVE_MESHES = ((2, 2), (1, 4))
PROMPT, DECODE_STEPS, MAX_LEN = 16, 12, 16
#: the elastic run's trainer shape
ELASTIC = dict(global_batch=4, seq_len=16, total_steps=100, ckpt_every=2,
               optimizer="adamw", seed=0)
ELASTIC_ARCH = "chatglm3-6b"


def f32(arch):
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def ref_leaf(ref_specs, name):
    """The reference's spec of the port's parameter ``name`` (a tuple),
    its layer-stacked leading ``None`` dropped, and the reference path."""
    parts = name.split(".")
    node, path = ref_specs, []
    if parts[0] == "blocks":
        period = len(ref_specs["blocks"])
        node = ref_specs["blocks"][int(parts[1]) % period]
        path = ["blocks", int(parts[1]) % period]
        rest, stacked = parts[2:], True
    elif parts[0] == "encoder":
        node = ref_specs["encoder"]
        path = ["encoder"]
        rest, stacked = parts[2:], True
    else:
        rest, stacked = parts, False
    for p in rest:
        node = node[p]
        path.append(p)
    spec = tuple(node)
    if stacked:
        assert spec[0] is None, (name, spec)
        spec = spec[1:]
    return spec, tuple(path), stacked


def ref_paths(tree, prefix=()):
    """Every leaf path of the reference's spec tree."""
    from jax.sharding import PartitionSpec as P
    if isinstance(tree, P):
        return {prefix}
    if isinstance(tree, dict):
        return set().union(*(ref_paths(v, prefix + (k,))
                             for k, v in tree.items()))
    return set().union(*(ref_paths(v, prefix + (i,))
                         for i, v in enumerate(tree)))


def _opt(name):
    from repro_torch.optim import cosine_schedule, make_optimizer
    return make_optimizer(name, cosine_schedule(3e-4, 2, 10))


def _moments(st, full):
    """The optimizer's per-leaf state as numpy: AdamW's m and v, or
    Adafactor's vr and vc."""
    o = st.opt_state
    pairs = (("m", o.m), ("v", o.v)) if hasattr(o, "m") else \
        (("vr", o.vr), ("vc", o.vc))
    return {kind: {k: full(t) for k, t in d.items()} for kind, d in pairs}


class _Recording:
    """An optimizer that keeps each step's (clipped) gradients."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        self.grads.append({k: g.detach().numpy().copy()
                           for k, g in grads.items()})
        return self.opt.update(grads, state, params)


def single_losses(arch, opt="adamw", steps=STEPS):
    """Single-process run of ``steps`` steps: losses, grad norms, initial
    and final parameters, each step's gradients and the optimizer's
    state."""
    from repro_torch.train.step import build_train_step, make_state
    cfg = f32(arch)
    rec = _Recording(_opt(opt))
    st = make_state(0, cfg, rec, device="cpu")
    init = {k: p.detach().numpy().copy()
            for k, p in st.params.named_parameters()}
    step = build_train_step(cfg, rec, n_micro=1, use_flash=False)
    losses, norms = [], []
    for i in range(steps):
        st, m = step(st, make_batch(cfg, BATCH, SEQ, key=i, device="cpu"))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    params = {k: p.detach().numpy().copy()
              for k, p in st.params.named_parameters()}
    return dict(losses=losses, norms=norms, init=init, params=params,
                grads=rec.grads,
                state=_moments(st, lambda t: t.numpy().copy()))


def _ranked_losses(arch, mesh, opt):
    from repro_torch.train.step import build_train_step, make_state
    cfg = f32(arch)
    optimizer = _opt(opt)
    st = make_state(0, cfg, optimizer, device="cpu", mesh=mesh)
    step = build_train_step(cfg, optimizer, n_micro=1, use_flash=False)
    rows = st.params.shard.batch_rows(BATCH)
    losses, norms = [], []
    for i in range(STEPS):
        b = make_batch(cfg, BATCH, SEQ, key=i, device="cpu")
        st, m = step(st, {k: v[rows] for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    params = {k: p.full_tensor().detach().numpy().copy()
              for k, p in st.params.named_parameters()}
    return dict(losses=losses, norms=norms, params=params,
                state=_moments(st, lambda t: t.full_tensor().numpy().copy()))


def _scaled_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    return float((got - want).abs().max() / want.abs().max())


def _served(arch, window, mesh):
    """The sharded prefill and decode steps on ``mesh`` against the same
    steps of the unsharded model (same seed) on this rank's rows: the
    largest scaled error over the prefill's logits and every decode
    step's, taken over all ranks."""
    import torch.distributed as dist
    from repro_torch import distributed as D
    from repro_torch.serve.step import build_prefill_step, build_serve_step
    cfg = f32(arch)
    if window is not None:
        cfg = dataclasses.replace(cfg, window=window)
    ref = T.init(0, cfg, device="cpu")
    model = D.distribute_model(T.init(0, cfg, device="cpu"),
                               T.param_specs(cfg), mesh)
    rows = model.shard.batch_rows(BATCH)
    b = make_batch(cfg, BATCH, PROMPT, key=7, device="cpu")
    mine = {k: v[rows] for k, v in b.items()}
    prefill = build_prefill_step(cfg, use_flash=False)
    errs = [_scaled_err(prefill(model, mine), prefill(ref, b)[rows])]
    cache_ref = T.decode_init(cfg, BATCH, MAX_LEN, device="cpu")
    cache = T.decode_init(cfg, BATCH, MAX_LEN, device="cpu", mesh=mesh)
    if "extra" in b:
        cache_ref = T.prime_cross_kv(ref, cfg, cache_ref, b["extra"])
        cache = T.prime_cross_kv(model, cfg, cache, mine["extra"])
    serve = build_serve_step(cfg)
    tokens = b["tokens"]
    for t in range(DECODE_STEPS):
        tok = tokens[:, t % PROMPT:t % PROMPT + 1]
        _, want, cache_ref = serve(ref, tok, t, cache_ref)
        _, got, cache = serve(model, tok[rows], t, cache)
        errs.append(_scaled_err(got, want[rows]))
    err = torch.tensor(max(errs), dtype=torch.float64)
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    return float(err), len(errs)


def _steps(tr, n):
    """The losses of ``n`` more steps (``run`` returns its whole log)."""
    return [m["loss"] for m in tr.run(n_steps=n, log_every=1)["metrics"]
            ][-n:]


def _elastic(mesh_a, mesh_b, workdir):
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.train.trainer import Trainer
    tr = Trainer(f32(ELASTIC_ARCH), mesh_a, workdir, **ELASTIC)
    try:
        got = _steps(tr, 2)
        tr.restore_elastic(mesh_b)
        got += _steps(tr, 1)
        save_checkpoint(workdir, tr.data_state.step, tr.state,
                        aux={"data": tr.data_state.to_dict()})
        tr.restore_elastic(torch.device("cpu"))
        got += _steps(tr, 1)
        return got
    finally:
        tr.close()


def _placements(mesh, workdir):
    """A plain tree saved, then loaded as DTensors laid out by
    ``load_checkpoint(placements=...)``: each rank's shard and the whole
    array as gathered."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    tree = {"a": torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8),
            "b": torch.ones(3)}
    save_checkpoint(workdir, 1, tree)
    got, _ = load_checkpoint(
        workdir, {"a": torch.empty(16, 8), "b": torch.empty(3)},
        placements={"a": (mesh, (Shard(0), Shard(1))),
                    "b": (mesh, (Replicate(), Replicate()))})
    return (tuple(got["a"].to_local().shape), got["a"].full_tensor().numpy(),
            got["b"].full_tensor().numpy())


def rank_main(rank, port, workdir, out):
    """One rank of the 4-process gloo world: every (arch, mesh,
    optimizer) case's two train steps, the served cases, then the elastic
    run; rank 0 reports."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)   # four ranks share the host's cores
    try:
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=WORLD)
        res = {}
        L.set_moe_buffer_sharding(("model", "data", None))
        meshes = {shape: init_device_mesh("cpu", shape,
                                          mesh_dim_names=("data", "model"))
                  for shape in RANK_MESHES}
        for shape, sp, opt in TRAIN_CASES:
            T.set_activation_sharding(SP_SPEC if sp else None)
            for arch in RANK_ARCHS:
                res[(arch, shape, sp, opt)] = _ranked_losses(
                    arch, meshes[shape], opt)
        T.set_activation_sharding(None)
        for shape in SERVE_MESHES:
            for arch, window in SERVE_ARCHS:
                res[("serve", arch, shape)] = _served(arch, window,
                                                      meshes[shape])
        res["elastic"] = _elastic(meshes[(2, 2)], meshes[(4, 1)], workdir)
        res["placements"] = _placements(meshes[(2, 2)], workdir + "/pl")
        if rank == 0:
            out.put(("ok", res))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        out.put(("error", f"rank {rank}: {traceback.format_exc()}"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(workdir, wait_s):
    """Spawn the world and return rank 0's results; every rank is stopped
    before this returns."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, port, str(workdir), out),
                         daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        try:
            kind, res = out.get(timeout=wait_s)
        except queue.Empty:
            raise TimeoutError(f"the gloo world gave no result in "
                               f"{wait_s} s")
        if kind != "ok":
            raise RuntimeError(res)
        return res
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)


def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))

