"""Fault-tolerant Trainer on a mesh or one device.

A port of the reference package's ``repro.train.trainer``:
``Trainer(cfg, mesh, workdir, ...)`` trains on a ``DeviceMesh`` (the
parameters and the optimizer state sharded by their specs, each
data-parallel rank running its rows of every batch, ``auto_microbatches``
keeping a microbatch divisible over them), and ``Trainer(cfg, workdir,
device=...)`` -- or a ``torch.device`` where the mesh goes -- on one device,
unsharded (a world of one).

  * checkpoint/restart -- async checkpoints every ``ckpt_every`` steps; on
    construction the trainer resumes from the latest checkpoint
    (parameters, optimizer state, step counter AND data-pipeline cursor);
  * preemption -- SIGTERM (or ``request_stop()``) leads to a final
    synchronous checkpoint before the run returns;
  * straggler detection -- per-step times, taken after a
    ``torch.cuda.synchronize`` on a card, feed an EWMA z-score; steps
    slower than ``straggler_z`` sigma are recorded (the first 3 steps,
    which carry the warm-up, are left out);
  * elastic restore -- ``restore_elastic(new_mesh)`` reloads the same
    checkpoint onto another mesh or a plain device (the checkpoint holds
    full arrays, and the data pipeline is step-indexed, so the batch
    stream is unchanged).
"""

from __future__ import annotations

import math
import signal
import threading
import time
from typing import Any, Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import distributed as D
from repro_torch.ckpt import (CheckpointManager, barrier, latest_step,
                              load_checkpoint, save_checkpoint)
from repro_torch.data import DataState, SyntheticLM
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import extra_shape
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.train.step import (auto_microbatches, build_train_step,
                                    make_state, to_device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _place(where):
    """(mesh or None, the device this rank computes on)."""
    if isinstance(where, DeviceMesh):
        if where.device_type == "cuda":
            return where, torch.device("cuda", torch.cuda.current_device())
        return where, torch.device(where.device_type)
    return None, torch.device(where)


class Trainer:
    def __init__(self, cfg: ModelConfig, mesh, workdir: Optional[str] = None,
                 *, device=None, global_batch: int = 8, seq_len: int = 128,
                 lr: float = 3e-4, total_steps: int = 1000,
                 ckpt_every: int = 50, seed: int = 0,
                 optimizer: str = "adamw", straggler_z: float = 3.0,
                 use_flash: bool = False):
        if workdir is None:   # Trainer(cfg, workdir, device=...)
            mesh, workdir = (device if device is not None else "cuda"), mesh
        self.cfg = cfg
        self.mesh, self.device = _place(mesh)
        self.workdir = workdir
        self.seed = seed
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.total_steps = total_steps
        self.ckpt_every = ckpt_every
        self.straggler_z = straggler_z
        self.use_flash = use_flash
        self.stragglers: list = []
        self._stop = False

        self.optimizer = make_optimizer(
            optimizer, cosine_schedule(lr, min(100, total_steps // 10 + 1),
                                       total_steps))
        self.train_step = self._build_step()
        self.data = SyntheticLM(cfg.vocab, seq_len, global_batch, seed=seed,
                                extra_shape=extra_shape(cfg, global_batch))
        self.state = make_state(seed, cfg, self.optimizer, self.device,
                                self.mesh)
        self.data_state = DataState(seed=seed, step=0)
        self.ckpt = CheckpointManager(workdir)
        self.metrics_log: list = []

        # resume if a checkpoint exists
        if latest_step(workdir) is not None:
            self.restore()

        self._prev_sigterm = None
        if threading.current_thread() is threading.main_thread():
            prev = signal.signal(signal.SIGTERM, self._on_sigterm)
            self._prev_sigterm = signal.SIG_DFL if prev is None else prev

    def _build_step(self):
        dp = D.dp_size(self.mesh) if self.mesh is not None else 1
        n_micro = auto_microbatches(self.cfg, self.global_batch,
                                    self.seq_len, dp)
        return build_train_step(self.cfg, self.optimizer, n_micro=n_micro,
                                use_flash=self.use_flash)

    # -- fault-tolerance hooks -------------------------------------------------
    def _on_sigterm(self, signum, frame):
        self.request_stop()

    def request_stop(self):
        """Preemption notice: checkpoint at the next step boundary and stop."""
        self._stop = True

    def close(self):
        """Wait for the checkpoint in flight and hand SIGTERM back to the
        handler that was set before this trainer (the signal module would
        otherwise keep the trainer, and its state on the card, alive)."""
        self.ckpt.wait()
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None

    def restore(self, mesh=None):
        """Load the latest checkpoint into the trainer's state, laid out
        on its mesh or device (on ``mesh`` instead: an elastic restore)."""
        if mesh is not None and mesh is not self.mesh:
            return self.restore_elastic(mesh)
        self.ckpt.wait()
        barrier()   # rank 0's write is done on every rank
        self.state, aux = load_checkpoint(self.workdir, self.state,
                                          device=self.device)
        self.data_state = DataState.from_dict(aux["data"])

    def restore_elastic(self, new_mesh):
        """Elastic re-mesh: resume the run from its latest checkpoint on
        another mesh, or a plain device (a ``torch.device`` or its
        name)."""
        self.ckpt.wait()
        self.mesh, self.device = _place(new_mesh)
        self.train_step = self._build_step()
        self.state = None   # free the old layout before the new one
        self.state = make_state(self.seed, self.cfg, self.optimizer,
                                self.device, self.mesh)
        self.restore()

    # -- main loop ---------------------------------------------------------------
    def run(self, n_steps: Optional[int] = None,
            log_every: int = 10) -> Dict[str, Any]:
        n_steps = n_steps if n_steps is not None else self.total_steps
        times = []
        ew_mean, ew_var = None, 0.0
        start_step = self.data_state.step
        for step in range(start_step, min(start_step + n_steps,
                                          self.total_steps)):
            if self._stop:
                break
            batch = to_device(self.data.batch_at(step), self.device)
            if self.mesh is not None:   # this rank's rows
                rows = D.ctx_of(self.state.params).batch_rows(
                    self.global_batch)
                batch = {k: v[rows] for k, v in batch.items()}
            _sync(self.device)
            t0 = time.perf_counter()
            self.state, metrics = self.train_step(self.state, batch)
            _sync(self.device)
            dt = time.perf_counter() - t0
            times.append(dt)

            # straggler detection (EWMA z-score over step times); the
            # first few steps carry the warm-up transient and are
            # excluded from the statistics
            if len(times) <= 3:
                pass
            elif ew_mean is None:
                ew_mean = dt
            else:
                if ew_var > 0:
                    z = (dt - ew_mean) / math.sqrt(ew_var)
                    if z > self.straggler_z and len(times) > 5:
                        self.stragglers.append((step, dt, z))
                ew_mean = 0.9 * ew_mean + 0.1 * dt
                ew_var = 0.9 * ew_var + 0.1 * (dt - ew_mean) ** 2
            self.data_state = DataState(self.data_state.seed, step + 1)

            if step % log_every == 0 or step == self.total_steps - 1:
                self.metrics_log.append(
                    {"step": step, "loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"]), "dt": dt})
            if (step + 1) % self.ckpt_every == 0:
                self.ckpt.save_async(step + 1, self.state,
                                     aux={"data": self.data_state.to_dict()})
        if self._stop:
            # preemption: final synchronous checkpoint
            self.ckpt.wait()
            save_checkpoint(self.workdir, self.data_state.step, self.state,
                            aux={"data": self.data_state.to_dict()})
        self.ckpt.wait()
        return {"metrics": self.metrics_log, "stragglers": self.stragglers,
                "final_step": self.data_state.step}
