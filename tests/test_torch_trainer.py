"""The port's fault-tolerant Trainer, checkpoints and launcher, on the CPU.

The checks of ``tests/test_train_ft.py`` run on the port's ``Trainer``
with ``device="cpu"`` (the reference's ``Trainer`` fails on this JAX
version, ROADMAP queue 3 b, so this file runs the port alone): the loss
falls, a restart resumes bitwise, preemption writes the final checkpoint,
an injected straggler is found, and ``restore_elastic`` resumes at the
right step.  Then the checkpoint's layout and guarantees, and the
launcher at the smoke config.
"""

import dataclasses
import json
import os
import signal
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import (CheckpointManager, latest_step,  # noqa: E402
                              load_checkpoint, save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import make_state  # noqa: E402
from repro_torch.train import trainer as trainer_module  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402


@pytest.fixture
def small_trainer(tmp_path):
    """Makes trainers at the smoke config; closes them at teardown, so no
    trainer's SIGTERM handler outlives its test."""
    made = []

    def make(workdir="run", **kw):
        cfg = get_config("chatglm3-6b", smoke=True)
        defaults = dict(global_batch=4, seq_len=32, total_steps=60,
                        ckpt_every=10, lr=1e-3, device="cpu")
        defaults.update(kw)
        made.append(Trainer(cfg, str(tmp_path / workdir), **defaults))
        return made[-1]
    yield make
    for tr in reversed(made):
        tr.close()


def test_loss_decreases(small_trainer):
    tr = small_trainer()
    out = tr.run(n_steps=30)
    losses = [m["loss"] for m in out["metrics"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_checkpoint_restart_resumes_bitwise(small_trainer):
    ref = small_trainer("ref")
    ref.run(n_steps=30, log_every=1)
    ref_losses = {m["step"]: m["loss"] for m in ref.metrics_log}

    # 20 steps (checkpoints at 10 and 20), then a fresh trainer on the same
    # workdir resumes from step 20 with the uninterrupted run's losses
    tr1 = small_trainer("a")
    tr1.run(n_steps=20, log_every=1)
    tr1.ckpt.wait()
    tr2 = small_trainer("a")
    assert tr2.data_state.step == 20 and tr2.state.step == 20
    assert tr2.state.opt_state.step == 20
    out = tr2.run(n_steps=10, log_every=1)
    assert [m["step"] for m in out["metrics"]] == list(range(20, 30))
    for m in out["metrics"]:
        assert m["loss"] == ref_losses[m["step"]], m
    for (name, a), (_, b) in zip(ref.state.params.named_parameters(),
                                 tr2.state.params.named_parameters()):
        assert torch.equal(a, b), name


def test_preemption_checkpoints_on_stop(small_trainer):
    tr = small_trainer("b", ckpt_every=1000)   # no periodic checkpoints
    tr.run(n_steps=5)
    assert latest_step(tr.workdir) is None
    tr.request_stop()
    out = tr.run(n_steps=10)      # stops at once, final sync checkpoint
    assert out["final_step"] == 5
    assert latest_step(tr.workdir) == out["final_step"]


def test_sigterm_requests_a_stop_and_close_restores_the_handler(
        small_trainer):
    before = signal.getsignal(signal.SIGTERM)
    tr = small_trainer("c", ckpt_every=1000)
    if threading.current_thread() is threading.main_thread():
        assert signal.getsignal(signal.SIGTERM) == tr._on_sigterm
    tr._on_sigterm(signal.SIGTERM, None)   # what the signal would call
    out = tr.run(n_steps=3)
    assert out["final_step"] == 0 and latest_step(tr.workdir) == 0
    tr.close()
    if threading.current_thread() is threading.main_thread():
        assert signal.getsignal(signal.SIGTERM) == before


class ScriptedClock:
    """Stands in for the ``time`` module that ``repro_torch.train.trainer``
    reads.  ``perf_counter`` returns the scripted time, which moves only
    where the test wraps code: a wrapped train step adds the step's
    scripted duration, wrapped host work ``OUTSIDE_S``.  A step time that
    equals its script therefore spans the train step and nothing else,
    whatever the host's load."""

    OUTSIDE_S = 10.0

    def __init__(self, durations):
        self.durations = list(durations)
        self._next = iter(self.durations)
        self._now = 0.0

    def perf_counter(self):
        return self._now

    def step(self, fn):
        def timed(*args, **kw):
            out = fn(*args, **kw)
            self._now += next(self._next)
            return out
        return timed

    def outside(self, fn):
        def timed(*args, **kw):
            self._now += self.OUTSIDE_S
            return fn(*args, **kw)
        return timed


def test_straggler_detection(small_trainer, monkeypatch):
    """A warm-up that settles, then steps of 0.1 s with a millisecond's
    jitter; step 24 takes 1 s more.  Each logged step time is its scripted
    duration (the batch's 10 s on the host are not in it), and the
    detector (the reference's EWMA z-score) flags step 24 and no other."""
    durations = [0.5, 0.3, 0.2, 0.15, 0.12, 0.11, 0.105] + \
        [0.1 + 0.001 * ((7 * i) % 5 - 2) for i in range(7, 40)]
    durations[24] += 1.0
    clock = ScriptedClock(durations)
    monkeypatch.setattr(trainer_module, "time", clock)
    tr = small_trainer("s", total_steps=40, ckpt_every=1000,
                       straggler_z=2.5, lr=3e-4)
    tr.train_step = clock.step(tr.train_step)
    monkeypatch.setattr(tr.data, "batch_at", clock.outside(tr.data.batch_at))
    out = tr.run(n_steps=40, log_every=1)
    assert out["final_step"] == 40
    assert [m["step"] for m in out["metrics"]] == list(range(40))
    assert [m["dt"] for m in out["metrics"]] == \
        pytest.approx(durations, rel=0, abs=1e-9)
    assert [s[0] for s in out["stragglers"]] == [24]


def test_elastic_restore_resumes(small_trainer):
    tr = small_trainer("e", total_steps=40)
    tr.run(n_steps=10)
    tr.ckpt.wait()
    tr.run(n_steps=3)             # moves past the checkpoint
    tr.restore_elastic("cpu")
    assert tr.data_state.step == 10 and tr.state.step == 10
    out = tr.run(n_steps=5)
    assert out["final_step"] == 15


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _state():
    cfg = get_config("gemma2-9b", smoke=True)
    return make_state(0, cfg, AdamW(), device="cpu")


def test_checkpoint_layout_and_bf16_round_trip(tmp_path):
    st = _state()
    st.opt_state.m["embed"].normal_()
    d = str(tmp_path / "ck")
    final = save_checkpoint(d, 7, st._replace(step=7), aux={"data": {"x": 1}})
    assert os.path.basename(final) == "step_00000007"
    assert sorted(os.listdir(final)) == ["manifest.json", "shard_00000.npz"]
    with open(os.path.join(d, "LATEST")) as f:
        assert f.read() == "step_00000007"
    with open(os.path.join(final, "manifest.json")) as f:
        man = json.load(f)
    assert man["dtypes"]["leaf_0"] == "bfloat16"
    assert man["treedef"][0] == "params/embed"
    assert man["treedef"][-1] == "step"
    with np.load(os.path.join(final, "shard_00000.npz")) as z:
        assert z["leaf_0"].dtype == np.float32

    fresh = _state()
    back, aux = load_checkpoint(d, fresh)
    assert aux == {"data": {"x": 1}} and back.step == 7
    assert back.params is fresh.params
    for (name, a), (_, b) in zip(st.params.named_parameters(),
                                 back.params.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert torch.equal(back.opt_state.m["embed"], st.opt_state.m["embed"])


def test_leftover_tmp_directory_is_ignored(tmp_path):
    d = str(tmp_path / "ck")
    st = _state()
    save_checkpoint(d, 10, st)
    # a save that died before its rename leaves only a .tmp-* directory
    os.makedirs(os.path.join(d, "step_00000020.tmp-deadbeef"))
    assert latest_step(d) == 10
    load_checkpoint(d, st)
    mgr = CheckpointManager(d, keep=1)
    mgr.save_async(30, st)
    mgr.wait()
    assert latest_step(d) == 30
    names = sorted(os.listdir(d))
    assert "step_00000010" not in names       # kept only the last one
    assert "step_00000020.tmp-deadbeef" in names


def test_async_save_snapshots_the_state(tmp_path):
    d = str(tmp_path / "ck")
    st = _state()
    before = st.params.embed.detach().clone()
    mgr = CheckpointManager(d)
    mgr.save_async(1, st)
    with torch.no_grad():
        st.params.embed.add_(1.0)   # the trainer moves on at once
    mgr.wait()
    back, _ = load_checkpoint(d, _state())
    assert torch.equal(back.params.embed, before)


def test_load_refuses_another_state(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, _state())
    cfg = dataclasses.replace(get_config("gemma2-9b", smoke=True), d_ff=96)
    other = make_state(0, cfg, AdamW(), device="cpu")
    with pytest.raises(ValueError, match="has shape"):
        load_checkpoint(d, other)
    other.opt_state.m.pop("embed")
    with pytest.raises(ValueError, match="holds leaves"):
        load_checkpoint(d, other)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------
def test_launcher_runs_at_the_smoke_config(tmp_path, capsys):
    out = launcher.main(["--arch", "chatglm3-6b", "--steps", "12",
                         "--batch", "2", "--seq", "16", "--device", "cpu",
                         "--workdir", str(tmp_path / "w")])
    assert out["final_step"] == 12
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])
    text = capsys.readouterr().out
    assert "optimizer=adamw" in text and "done at step 12" in text
    assert latest_step(str(tmp_path / "w")) == 10   # max(10, 12 // 4)
    tr = launcher.make_trainer(["--arch", "gemma2-9b", "--optimizer",
                                "adafactor", "--device", "cpu", "--workdir",
                                str(tmp_path / "x")])
    assert type(tr.optimizer).__name__ == "Adafactor"
    tr.close()
