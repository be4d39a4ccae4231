"""Multi-pod dry-run: trace every (arch x input-shape x mesh) cell on a
fake world of 256 or 512 ranks.

A port of the reference package's ``repro.launch.dryrun``.  Where the
reference lowers and compiles each cell for 512 fake XLA devices, this
runs the port's own sharded step once as rank 0 of a fake process group
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once) with every tensor a fake tensor (``FakeTensorMode``: shapes and
dtypes, no storage), so no model-sized buffer is allocated.  For each
cell it writes, per rank:

* ``memory``: bytes of parameters, optimizer state, batch and cache this
  rank holds, and ``peak_bytes``, the most its tensors held live at once
  during the step (every storage an operation made, until it was freed);
* ``cost_analysis.flops``: the rank's own matmul and attention FLOPs
  (``FlopCounterMode`` over its local operations only: a DTensor-level
  product would count the global operation too);
* ``collective_bytes`` / ``collective_count`` by kind and
  ``collective_bytes_total``: every functional collective the step
  issued (DTensor's weight gathers and gradient reduce-scatters, the
  tensor-parallel sums, the MoE dispatch), by output bytes as the
  reference counts them;
* ``param_count``, ``active_param_count``, ``optimizer`` (Adafactor above
  3e11 parameters), ``n_micro`` and ``step_kind``, as the reference's.

A train cell traces one microbatch's forward and backward and the
clipping and update once, and counts the microbatch ``n_micro`` times
(the microbatches have one shape).  The reference's ``compile_s``,
``hlo_lines`` and XLA ``memory_analysis`` fields have no counterpart
here (no compiler runs); ``trace_s`` stands where ``lower_s`` does.

Writes ``build/dryrun/<arch>__<shape>__<mesh>[__opt].json`` (``--out``
to put them elsewhere).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b \\
      --shape train_4k --mesh single                                 # one
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import distributed as D
from repro_torch.configs import all_arch_ids, get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES, ModelConfig
from repro_torch.models.registry import extra_shape, shape_applicable
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.serve.step import build_prefill_step, build_serve_step
from repro_torch.train.step import auto_microbatches, make_state

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "..", "..", "..", "build", "dryrun")
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
#: functional collective -> the reference's HLO kind
_KINDS = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all"}
#: the reference's keys that no torch trace has
NO_COUNTERPART = ("compile_s", "hlo_lines", "memory_analysis")
SKIP_REASON = ("long_500k needs sub-quadratic attention; {arch} is "
               "full-attention (see DESIGN.md)")


class StepCounters(TorchDispatchMode):
    """Collectives by kind (count and output bytes) and the live bytes of
    every storage an operation makes (freed when its last tensor dies)."""

    def __init__(self):
        super().__init__()
        self.count = {k: 0 for k in COLLECTIVES}
        self.bytes = {k: 0 for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        from torch.utils.weak import WeakIdKeyDictionary
        self._seen = WeakIdKeyDictionary()

    def track(self, t) -> None:
        if D.is_dtensor(t):
            t = t.to_local()
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "_c10d_functional":
            kind = _KINDS.get(func._opname)
            if kind is not None:
                outs = [t for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor)]
                self.count[kind] += 1
                self.bytes[kind] += sum(t.numel() * t.element_size()
                                        for t in outs)
        for t in tree_flatten(out)[0]:
            self.track(t)
        return out


def fake_world(n: int) -> None:
    """Rank 0 of a fake process group of ``n`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def make_mesh(mesh_name: str):
    from repro_torch.launch.mesh import make_production_mesh
    fake_world(512 if mesh_name == "multi" else 256)
    return make_production_mesh(multi_pod=mesh_name == "multi",
                                device_type="cpu")


def _flops() -> "torch.utils.flop_counter.FlopCounterMode":
    from torch.utils.flop_counter import FlopCounterMode
    return FlopCounterMode(display=False)


def _bytes(tensors) -> int:
    return sum(D.local_bytes(t) for t in tensors
               if isinstance(t, torch.Tensor))


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _batch(cfg: ModelConfig, rows: int, seq: int) -> Dict[str, torch.Tensor]:
    out = {"tokens": torch.zeros((rows, seq), dtype=torch.int64),
           "labels": torch.zeros((rows, seq), dtype=torch.int64)}
    es = extra_shape(cfg, rows)
    if es is not None:
        out["extra"] = torch.zeros(es, dtype=torch.float32)
    return out


def trace_cell(cfg: ModelConfig, shape, mesh) -> Dict[str, Any]:
    """One cell's step on ``mesh`` (``None``: the unsharded step), under
    fake tensors: its memory, FLOPs and collectives on this rank."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dp = D.dp_size(mesh) if mesh is not None else 1
    B, S = shape.global_batch, shape.seq_len
    split = B % dp == 0
    rows = B // dp if split else B
    info: Dict[str, Any] = {}
    mem: Dict[str, int] = {}
    flops, counters = _flops(), StepCounters()
    with FakeTensorMode(allow_non_fake_inputs=True):
        if shape.kind == "train":
            opt_name = "adafactor" if cfg.param_count() > 3e11 else "adamw"
            opt = make_optimizer(opt_name, cosine_schedule(3e-4, 100, 10000))
            state = make_state(0, cfg, opt, device="cpu", mesh=mesh)
            n_micro = int(os.environ.get("REPRO_N_MICRO", "0")) or \
                auto_microbatches(cfg, B, S, dp)
            info.update(optimizer=opt_name, n_micro=n_micro,
                        step_kind="train_step")
            params = dict(state.params.named_parameters())
            mem["param_bytes"] = _bytes(params.values())
            mem["optimizer_bytes"] = _bytes(_leaves(state.opt_state[1:]))
            micro = _batch(cfg, rows // n_micro, S)
            mem["batch_bytes"] = _bytes(micro.values()) * n_micro
            for t in _leaves(state.params) + _leaves(state.opt_state):
                counters.track(t)
            t0 = time.perf_counter()
            with counters, flops:
                acc = None
                if n_micro > 1:   # the step's float32 gradient sums
                    acc = [torch.zeros(D.local(p).shape, dtype=torch.float32)
                           for p in params.values()]
                loss = T.loss_fn(state.params, cfg, micro, use_flash=False)
                loss.backward()
            micro_flops = flops.get_total_flops()
            micro_count = dict(counters.count)
            micro_bytes = dict(counters.bytes)
            opt_flops, opt_counters = _flops(), StepCounters()
            with counters, opt_counters, opt_flops:
                from repro_torch.optim import clip_by_global_norm
                grads = {k: p.grad for k, p in params.items()}
                grads, _ = clip_by_global_norm(grads, 1.0, params)
                opt.update(grads, state.opt_state, params)
            del acc
            info["trace_s"] = time.perf_counter() - t0
            total_flops = n_micro * micro_flops + opt_flops.get_total_flops()
            count = {k: n_micro * micro_count[k] + opt_counters.count[k]
                     for k in COLLECTIVES}
            cbytes = {k: n_micro * micro_bytes[k] + opt_counters.bytes[k]
                      for k in COLLECTIVES}
        else:
            model = T.init(0, cfg, device="cpu")
            if mesh is not None:
                D.distribute_model(model, T.param_specs(cfg), mesh)
            mem["param_bytes"] = _bytes(_leaves(model))
            for t in _leaves(model):
                counters.track(t)
            t0 = time.perf_counter()
            if shape.kind == "prefill":
                batch = _batch(cfg, rows, S)
                batch.pop("labels")
                mem["batch_bytes"] = _bytes(batch.values())
                info["step_kind"] = "prefill_step"
                with counters, flops:
                    build_prefill_step(cfg, use_flash=False)(model, batch)
            else:
                cache = T.decode_init(cfg, B, S, device="cpu", mesh=mesh)
                mem["cache_bytes"] = _bytes(_leaves(cache))
                for t in _leaves(cache):
                    counters.track(t)
                tok = torch.zeros((rows, 1), dtype=torch.int64)
                mem["batch_bytes"] = _bytes([tok])
                info.update(step_kind="serve_step", kv_len=S)
                with counters, flops:
                    build_serve_step(cfg)(model, tok, S - 1, cache)
            info["trace_s"] = time.perf_counter() - t0
            total_flops = flops.get_total_flops()
            count, cbytes = dict(counters.count), dict(counters.bytes)
    mem["peak_bytes"] = counters.peak
    return {"memory": mem, "cost_analysis": {"flops": float(total_flops)},
            "collective_bytes_total": sum(cbytes.values()),
            "collective_bytes": cbytes, "collective_count": count, **info}


def lower_cell(arch: str, shape_name: str, mesh_name: str,
               smoke: bool = False) -> Dict[str, Any]:
    cfg = get_config(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skipped": SKIP_REASON.format(arch=arch)}
    mesh = make_mesh(mesh_name)
    why = D.validate_divisibility(cfg, shape, mesh)
    if why is not None:
        raise ValueError(why)
    res = trace_cell(cfg, shape, mesh)
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "n_chips": int(mesh.size()),
            "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            **res, "param_count": cfg.param_count(),
            "active_param_count": cfg.active_param_count(),
            "no_counterpart": list(NO_COUNTERPART)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (CI sanity)")
    ap.add_argument("--opt", action="store_true",
                    help="the beyond-paper changes (sequence parallelism "
                         "and the MoE buffers' slots over the data axes); "
                         "results tagged __opt")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)

    if args.opt:
        if os.environ.get("REPRO_OPT_SP", "1") == "1":
            T.set_activation_sharding(("data", "model", None))
        if os.environ.get("REPRO_OPT_MOE", "1") == "1":
            L.set_moe_buffer_sharding(("model", "data", None))

    archs = all_arch_ids() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    suffix = ("__opt" if args.opt else "") + os.environ.get("REPRO_TAG", "")
    try:
        for arch in archs:
            for shape_name in shapes:
                for mesh_name in meshes:
                    tag = f"{arch}__{shape_name}__{mesh_name}{suffix}"
                    t0 = time.time()
                    try:
                        res = lower_cell(arch, shape_name, mesh_name,
                                         smoke=args.smoke)
                    except Exception as e:
                        traceback.print_exc()
                        res = {"arch": arch, "shape": shape_name,
                               "mesh": mesh_name, "error": repr(e)}
                        failures.append(tag)
                    with open(os.path.join(args.out, f"{tag}.json"),
                              "w") as f:
                        json.dump(res, f, indent=2)
                    status = ("SKIP" if "skipped" in res else
                              "FAIL" if "error" in res else "OK")
                    extra = ""
                    if status == "OK":
                        m = res["memory"]
                        extra = (f" flops={res['cost_analysis']['flops']:.3g}"
                                 f" coll={res['collective_bytes_total']:.3g}B"
                                 f" params={m['param_bytes'] / 1e9:.3f}GB"
                                 f" peak={m['peak_bytes'] / 1e9:.3f}GB")
                    print(f"[{status}] {tag}{extra} "
                          f"({time.time() - t0:.0f}s)", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILED cells: {failures}")
        return 1
    print("\nALL CELLS TRACED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
