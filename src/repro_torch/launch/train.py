"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs the fault-tolerant :class:`~repro_torch.train.trainer.Trainer`.  A
world of one (no ``torchrun``) with no mesh asked for trains unsharded on
its one device, with no process group.  Otherwise it trains on a mesh over
the ranks of the world: a local ("data", "model") mesh (``--mesh
DATA,MODEL``; all ranks over "data" unless it says otherwise), or the
16x16 production mesh with ``--production-mesh`` (which needs 256 ranks).
``--device cuda`` (NCCL, one card per rank) unless asked for the CPU
(gloo).  A world of one given ``--mesh`` initialises itself; more ranks
come from ``torchrun --nproc-per-node N -m repro_torch.launch.train ...``.
Smoke-scale by default; ``--full`` takes the published config.  The
optimizer is the reference launcher's rule unless ``--optimizer`` names
one: Adafactor above 3e11 parameters, else AdamW.  :func:`make_trainer`
builds the trainer from the command line for callers that drive it
themselves.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import all_arch_ids, get_config
from repro_torch.distributed import init_world
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.train.trainer import Trainer


def _world() -> int:
    """The number of ranks: the process group's, torchrun's, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_trainer(argv=None) -> Trainer:
    """The launcher's trainer for ``argv`` (checkpoints every
    ``max(10, steps // 4)`` steps, as the reference launcher's)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b",
                    help=f"one of: {', '.join(all_arch_ids())}")
    ap.add_argument("--full", action="store_true",
                    help="the published config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_train"))
    ap.add_argument("--optimizer", default=None,
                    help="adamw|adafactor (default: by size)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL) or cpu (gloo)")
    ap.add_argument("--mesh", default=None,
                    help="DATA,MODEL of the local mesh (default: every "
                         "rank over data; a world of one: unsharded)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 production mesh (needs 256 ranks)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, smoke=not args.full)
    opt = args.optimizer or (
        "adafactor" if cfg.param_count() > 3e11 else "adamw")
    device = torch.device(args.device)
    kw = dict(global_batch=args.batch, seq_len=args.seq,
              total_steps=args.steps, lr=args.lr,
              ckpt_every=max(10, args.steps // 4), optimizer=opt)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    if args.mesh is None and not args.production_mesh and _world() == 1:
        print(f"{cfg.arch}: {cfg.param_count() / 1e6:.1f}M params, "
              f"optimizer={opt}, device={where}", flush=True)
        return Trainer(cfg, args.workdir, device=device, **kw)
    init_world(device.type)
    if args.production_mesh:
        mesh = make_production_mesh(device_type=device.type)
    else:
        data, model = (int(x) for x in args.mesh.split(",")) if args.mesh \
            else (dist.get_world_size(), 1)
        mesh = make_local_mesh(data, model, device_type=device.type)
    if dist.get_rank() == 0:
        print(f"{cfg.arch}: {cfg.param_count() / 1e6:.1f}M params, "
              f"optimizer={opt}, mesh="
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
              f"device={where}", flush=True)
    return Trainer(cfg, mesh, args.workdir, **kw)


def main(argv=None):
    tr = make_trainer(argv)
    try:
        out = tr.run()
    finally:
        tr.close()
    if not dist.is_initialized() or dist.get_rank() == 0:
        for m in out["metrics"]:
            print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
                  f"gnorm {m['grad_norm']:.2f}  {m['dt'] * 1e3:.0f}ms")
        print(f"done at step {out['final_step']}; "
              f"stragglers detected: {len(out['stragglers'])}")
    return out


if __name__ == "__main__":
    main()
