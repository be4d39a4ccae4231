"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs the fault-tolerant :class:`~repro_torch.train.trainer.Trainer` on one
device, ``--device cuda`` unless asked for the CPU.  Smoke-scale by default;
``--full`` takes the published config.  The optimizer is the reference
launcher's rule unless ``--optimizer`` names one: Adafactor above 3e11
parameters, else AdamW.  :func:`make_trainer` builds the trainer from the
command line for callers that drive it themselves.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import all_arch_ids, get_config
from repro_torch.train.trainer import Trainer


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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, smoke=not args.full)
    opt = args.optimizer or (
        "adafactor" if cfg.param_count() > 3e11 else "adamw")
    device = torch.device(args.device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"{cfg.arch}: {cfg.param_count() / 1e6:.1f}M params, "
          f"optimizer={opt}, device={where}", flush=True)
    return Trainer(cfg, args.workdir, device=device,
                   global_batch=args.batch, seq_len=args.seq,
                   total_steps=args.steps, lr=args.lr,
                   ckpt_every=max(10, args.steps // 4), optimizer=opt)


def main(argv=None):
    tr = make_trainer(argv)
    try:
        out = tr.run()
    finally:
        tr.close()
    for m in out["metrics"]:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.2f}  {m['dt'] * 1e3:.0f}ms")
    print(f"done at step {out['final_step']}; "
          f"stragglers detected: {len(out['stragglers'])}")
    return out


if __name__ == "__main__":
    main()
