"""The port's segments and asynchronous tune service against the JAX
reference and against its own synchronous path, on the CPU.

Same inputs go through ``repro`` (``backend="jax"``) and ``repro_torch``
(``device="cpu"``) at gups scale 0.02 (655 pages, 60 epochs):

* ``run_simulation_segment``: segmented equals unsegmented bitwise inside
  the port; against the reference, deterministic engines' (static, oracle)
  migrations are bitwise and walls within 1e-5, sampled engines' total_s
  within 1e-3 (the bars of ``tests/test_torch_engine.py``, which says
  why); the reference's host carry resumes in the port;
* the pure-Python modules (``asha``, ``trial``, ``journal``, ``faults``)
  give the reference's decisions and bytes on the same inputs;
* the executor commits in creation order, wraps failures, times units
  out, cancels on close and heals a killed (spawned) process worker;
* ``Study.tune(executor="async")``: at ``slots=1`` equal to the port's
  sync path bitwise for all five engines, ASHA journal twins, thread and
  process slots journal twins, resume of a complete, a torn and a
  SIGKILLed journal byte-identical, every journal valid under
  ``tools/journal_schema.py``; against the reference's async study the
  asked configs equal and the incumbent within 1%.

Every subprocess and pool a test starts is bounded by a deadline and
stopped in ``finally``.
"""

import dataclasses
import json
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import specs as jax_specs  # noqa: E402
from repro.core import engine_jax  # noqa: E402
from repro.core import simulator as jax_sim  # noqa: E402
from repro.core.study import Study as JaxStudy  # noqa: E402
from repro.core import tune_service as jts  # noqa: E402
from repro_torch.core import (ExperimentSpec, SimOptions, Study,  # noqa: E402
                              WorkloadSpec, engine_torch)
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import tune_service as ts  # noqa: E402
from repro_torch.core.knobs import Knob, KnobSpace, get_space  # noqa: E402
from repro_torch.core.tune_service import service as svc  # noqa: E402
from repro_torch.core.workloads import make_workload  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCALE = 0.02
ENGINES = ("hemem", "hmsdk", "memtis", "static", "oracle")
DETERMINISTIC = ("static", "oracle")
WALL_RTOL = 1e-5
TOTAL_RTOL = 1e-3
#: static/oracle have no registered knob space; a real-but-inert knob
#: gives the optimizer a domain (the reference's tests do the same)
TINY_SPACE = KnobSpace([Knob("max_migration_rate", 10, 2, 20, is_int=True)])
#: the kill/resume study (also run in a child process)
KILL_KW = dict(budget=12, seed=9, n_init=5, executor="async", slots=2,
               scheduler="asha")


def _spec(engine="hemem", **opts):
    return ExperimentSpec(
        engine=engine,
        workload=WorkloadSpec("gups", "8GiB-hot", threads=8, scale=SCALE),
        options=SimOptions(seed=3, crn=True, device="cpu", **opts))


def _jax_spec(engine="hemem"):
    return jax_specs.ExperimentSpec(
        engine=engine,
        workload=jax_specs.WorkloadSpec("gups", "8GiB-hot", threads=8,
                                        scale=SCALE),
        options=jax_specs.SimOptions(seed=3, crn=True, backend="jax"))


def _space_for(engine):
    try:
        return get_space(engine)
    except KeyError:
        return TINY_SPACE


def _configs(engine, B=3):
    space = _space_for(engine)
    rng = np.random.default_rng(5)
    return [space.default_config()] + [space.sample(rng)
                                       for _ in range(B - 1)]


def _histories_equal(a, b):
    return [(o.config, o.value) for o in a.history] == \
        [(o.config, o.value) for o in b.history]


def _schema_ok(*paths):
    """``tools/journal_schema.py`` on each journal, as a subprocess."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "journal_schema.py"),
         *map(str, paths)], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr


def _carries_equal(a, b):
    in_a, al_a, est_a, eng_a, cum_a, k_a = a
    in_b, al_b, est_b, eng_b, cum_b, k_b = b
    return (np.array_equal(in_a, in_b) and np.array_equal(al_a, al_b)
            and np.array_equal(est_a, est_b) and eng_a.keys() == eng_b.keys()
            and all(np.array_equal(eng_a[k], eng_b[k]) for k in eng_a)
            and np.array_equal(cum_a, cum_b) and np.array_equal(k_a, k_b))


# ---------------------------------------------------------------------------
# run_simulation_segment
# ---------------------------------------------------------------------------
def _wl():
    return make_workload("gups", "8GiB-hot", threads=8, scale=SCALE, seed=3)


def _seg(engine, cfgs, **kw):
    return tsim.run_simulation_segment(_wl(), engine, cfgs, seeds=3,
                                       crn=True, device="cpu", **kw)


@pytest.mark.parametrize("engine", ENGINES)
def test_segments_equal_the_whole_run_bitwise(engine):
    cfgs = _configs(engine)
    whole = _seg(engine, cfgs, return_carry=True)
    parts, carry = [], None
    for lo, hi in ((0, 15), (15, 30), (30, 60)):
        out = _seg(engine, cfgs, epoch_start=lo, epoch_stop=hi, carry=carry,
                   return_carry=True)
        parts.append(out["wall_ms"])
        carry = out["carry"]
        assert out["trace_reads"].shape == (hi - lo, _wl().n_pages)
    assert whole["wall_ms"].dtype == np.float64
    assert np.array_equal(np.concatenate(parts), whole["wall_ms"])
    assert _carries_equal(carry, whole["carry"])
    batch = tsim.run_simulation_batch(_wl(), engine, cfgs, seeds=3,
                                      sampler="sparse", crn=True,
                                      device="cpu")
    for b, r in enumerate(batch):
        assert np.array_equal(whole["wall_ms"][:, b], r.epoch_wall_ms)
        assert np.float32(r.cum_migrations[-1]) == carry[4][b]
    assert _seg(engine, cfgs)["carry"] is None


@pytest.mark.parametrize("engine", ENGINES)
def test_segments_against_the_reference(engine):
    cfgs = _configs(engine)
    kw = dict(seeds=3, sampler="sparse", crn=True)
    ref_parts, ref_carry = [], None
    ours_parts = []
    for lo, hi in ((0, 30), (30, 60)):
        ref = jax_sim.run_simulation_segment(
            _wl(), engine, cfgs, backend="jax", epoch_start=lo,
            epoch_stop=hi, carry=ref_carry, return_carry=True, **kw)
        # the reference's host carry resumes in the port
        ours = tsim.run_simulation_segment(
            _wl(), engine, cfgs, epoch_start=lo, epoch_stop=hi,
            carry=ref_carry, return_carry=True, device="cpu", **kw)
        ref_carry = engine_jax.carry_to_host(ref["carry"])
        ref_parts.append(ref["wall_ms"])
        ours_parts.append(ours["wall_ms"])
        if engine in DETERMINISTIC:
            assert np.array_equal(ours["carry"][4], ref_carry[4])
            np.testing.assert_allclose(ours["wall_ms"], ref["wall_ms"],
                                       rtol=WALL_RTOL)
    ref_total = np.concatenate(ref_parts).sum(0)
    ours_total = np.concatenate(ours_parts).sum(0)
    np.testing.assert_allclose(ours_total, ref_total, rtol=TOTAL_RTOL)


def test_segment_crn_forces_one_seed_and_checks_seeds():
    cfgs = _configs("hemem", 2)
    a = tsim.run_simulation_segment(_wl(), "hemem", cfgs, seeds=[3, 4],
                                    crn=True, device="cpu", epoch_stop=10)
    b = tsim.run_simulation_segment(_wl(), "hemem", cfgs, seeds=[3, 3],
                                    crn=True, device="cpu", epoch_stop=10)
    assert np.array_equal(a["wall_ms"], b["wall_ms"])
    with pytest.raises(ValueError, match="one seed per config"):
        tsim.run_simulation_segment(_wl(), "hemem", cfgs, seeds=[3],
                                    device="cpu")
    with pytest.raises(ValueError, match="carry"):
        tsim.run_simulation_segment(_wl(), "hemem", cfgs, device="cpu",
                                    epoch_start=10)


def test_broadcast_carry_row_equals_the_reference():
    carry = _seg("hemem", _configs("hemem"), epoch_stop=12,
                 return_carry=True)["carry"]
    for row, B in ((0, 4), (2, 1), (1, 3)):
        ours = engine_torch.broadcast_carry_row(carry, row, B)
        ref = engine_jax.broadcast_carry_row(carry, row, B)
        assert _carries_equal(ours, ref)
        assert ours[0].shape[0] == B and ours[1].shape == carry[1].shape


# ---------------------------------------------------------------------------
# the pure-Python modules against the reference's
# ---------------------------------------------------------------------------
def test_asha_decisions_equal_the_reference():
    for E in (1, 5, 20, 60, 61):
        assert ts.ASHAScheduler(E).rung_epochs == \
            jts.ASHAScheduler(E).rung_epochs
    rng = np.random.default_rng(0)
    for eta in (2, 3, 4):
        ours, ref = ts.ASHAScheduler(60, eta=eta), \
            jts.ASHAScheduler(60, eta=eta)
        for i in range(200):
            rung = int(rng.integers(0, 2))
            v = float(rng.choice([1.0, 2.0, float(rng.random())]))
            assert ours.report(rung, i, v) == ref.report(rung, i, v)
    for bad in (dict(max_epochs=0), dict(max_epochs=60, eta=1)):
        with pytest.raises(ValueError):
            ts.ASHAScheduler(**bad)
    with pytest.raises(ValueError, match="final budget"):
        ts.ASHAScheduler(60).report(2, 0, 1.0)


def test_trial_state_machine_and_value_at_equal_the_reference():
    assert ts.TRANSITIONS == jts.TRANSITIONS
    for src in ts.TRANSITIONS:
        for dst in list(ts.TRANSITIONS) + ["ZOMBIE"]:
            got = []
            for mod in (ts, jts):
                t = mod.Trial(index=0, config={}, encoded=np.zeros(1),
                              spec={}, seed=0, state=src)
                try:
                    t.advance(dst)
                    got.append(("ok", t.state, t.terminal))
                except ValueError as e:
                    got.append(("err", str(e)))
            assert got[0] == got[1]
    wall = np.linspace(1.0, 60.0, 60)
    for mod in (ts, jts):
        t = mod.Trial(index=0, config={"a": 1}, encoded=np.zeros(1),
                      spec={}, seed=0)
        t.epoch_wall_ms = [wall[:15], wall[15:30], wall[30:]]
        u = mod.Trial(index=1, config={}, encoded=np.zeros(1), spec={},
                      seed=0)
        u.epoch_wall_ms = [wall]
        for e in (15, 30, 60):
            assert t.value_at(e) == u.value_at(e) == float(wall[:e].sum()
                                                           / 1e3)
        with pytest.raises(ValueError, match="evaluated epochs"):
            t.value_at(61)
    mine = ts.Trial(index=3, config={"a": 1}, encoded=np.zeros(1), spec={},
                    seed=2, group=1)
    ref = jts.Trial(index=3, config={"a": 1}, encoded=np.zeros(1), spec={},
                    seed=2, group=1)
    assert mine.to_row() == ref.to_row()


def _journal_events():
    return [{"event": "study", "version": 3, "budget": 8},
            {"event": "ask", "trial": 0, "group": 0, "config": {"a": 1}},
            {"event": "eval", "trial": 0, "epochs": 15, "value": 2.5},
            {"event": "retry", "trial": 0, "attempt": 1, "epochs": 30,
             "error": "boom"},
            {"event": "tell", "trial": 0, "group": 0, "value": 1e-7}]


def test_journal_bytes_torn_tail_and_divergence_equal_the_reference(
        tmp_path):
    raws = []
    for mod, name in ((ts, "ours"), (jts, "ref")):
        path = str(tmp_path / f"{name}.jsonl")
        with mod.StudyJournal(path) as j:
            for ev in _journal_events():
                j.append(ev)
        raws.append(open(path, "rb").read())
        assert mod.VERSION == ts.VERSION
    assert raws[0] == raws[1]
    for mod, name in ((ts, "ours"), (jts, "ref")):
        path = str(tmp_path / f"{name}.jsonl")
        open(path, "wb").write(raws[0][:-9])      # SIGKILL mid-append
        assert [e["event"] for e in mod.read_events(path)] == \
            ["study", "ask", "eval", "retry"]
        with mod.StudyJournal(path, resume=True) as j:
            for ev in _journal_events()[:4]:
                assert j.append(ev) == ev
            assert not j.replaying
            j.append(_journal_events()[4])
        assert open(path, "rb").read() == raws[0]
        with mod.StudyJournal(path, resume=True) as j:
            with pytest.raises(ValueError, match="diverged"):
                j.append({"event": "study", "version": 3, "budget": 16})
        with mod.StudyJournal(path, resume=True) as j:
            with pytest.raises(ValueError, match="diverged"):
                j.append({"event": "ask", "trial": 0})
        with mod.StudyJournal(path, resume=True) as j:
            assert j.lookup("eval", trial=0)["value"] == 2.5
            assert j.lookup_first(("retry", "eval"), trial=0,
                                  epochs=30)["event"] == "retry"
    with pytest.raises(FileNotFoundError):
        ts.StudyJournal(str(tmp_path / "nope.jsonl"), resume=True)


def test_faults_equal_the_reference(tmp_path):
    kw = dict(kill=[(1, 0)], stall=[(2, 1)], hang=[(3, 0)], drop=[(4, 0)],
              dup=[(5, 0)], delay=[(6, 0, 0.5)], corrupt=[(7, 0)],
              truncate=[(8, 1)], replay=[(9, 0)],
              partition=[(10, 0, 1.5)], kill_every=4, kill_phase=3)
    ours, ref = ts.FaultPlan(**kw), jts.FaultPlan(**kw)
    assert pickle.loads(pickle.dumps(ours)) == ours
    names = ("kills", "stalls", "hangs", "drops", "dups", "delays",
             "corrupts", "truncates", "replays", "partitions")
    for u in range(12):
        for a in range(3):
            for name in names:
                assert getattr(ours, name)(u, a) == getattr(ref, name)(u, a)
    assert ts.NO_FAULTS.empty and not ours.empty
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    # the torn journal and the marker-file objectives
    src = tmp_path / "j.jsonl"
    src.write_bytes(b"".join(json.dumps(e, sort_keys=True).encode() + b"\n"
                             for e in _journal_events()))
    torn = []
    for mod, name in ((ts, "ours"), (jts, "ref")):
        path = tmp_path / f"torn_{name}.jsonl"
        path.write_bytes(src.read_bytes())
        mod.tear_journal(str(path), 3, tail_bytes=7)
        torn.append(path.read_bytes())
        with pytest.raises(ValueError, match="only"):
            mod.tear_journal(str(src), 5)
    assert torn[0] == torn[1]
    for mod, name in ((ts, "ours"), (jts, "ref")):
        d = tmp_path / f"fail_{name}"
        d.mkdir()
        obj = mod.FailNTimes(str(d), n=2)
        for _ in range(2):
            with pytest.raises(RuntimeError, match="transient"):
                obj({"sampling_period": 7})
        assert obj({"sampling_period": 7}) == 7.0


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------
def test_executor_commits_in_creation_order_and_wraps_failures():
    ex = ts.TrialExecutor(slots=4)
    try:
        delays = [0.03, 0.0, 0.02, 0.0]

        def unit(i):
            time.sleep(delays[i])
            if i == 2:
                raise RuntimeError("kaput")
            return {"value": i}

        for i in range(4):
            ex.submit(unit, i)
        got = [ex.pop_next() for _ in range(4)]
        assert [seq for seq, _ in got] == [0, 1, 2, 3]
        assert [r.get("value") for _, r in got] == [0, 1, None, 3]
        assert "kaput" in got[2][1]["error"] and "slot_s" in got[2][1]
        assert ex.outstanding == 0 and ex.busy_s > 0.0
    finally:
        ex.close()
    with pytest.raises(ValueError, match="slots"):
        ts.TrialExecutor(slots=0)
    with pytest.raises(ValueError, match="pool"):
        ts.TrialExecutor(slots=1, pool="fiber")


def test_executor_times_out_a_hung_unit_and_cancels_on_close():
    ex = ts.TrialExecutor(slots=2)
    ran = []
    try:
        def sleeper():
            time.sleep(0.6)
            return {"value": 1.0}

        def unit(i):
            ran.append(i)
            time.sleep(0.2)
            return {"value": i}

        ex.submit(sleeper, timeout_s=0.1)
        ex.submit(unit, 0)
        seq, r = ex.pop_next()
        assert seq == 0 and r.get("timeout") and r["slot_s"] == 0.1
        assert "timeout" in r["error"]
        assert ex.pop_next()[1]["value"] == 0
        for i in (1, 2, 3):
            ex.submit(unit, i)
        deadline = time.time() + 10
        while 1 not in ran and time.time() < deadline:
            time.sleep(0.005)
    finally:
        ex.close()      # units 2 and 3 are queued behind 1 and cancel
    time.sleep(0.3)
    assert ran[:2] == [0, 1] and 3 not in ran


def test_process_pool_worker_death_heals(tmp_path):
    # a spawned slot SIGKILLed mid-unit breaks the pool; the executor
    # rebuilds it and resubmits -- results are deterministic, so the study
    # matches a fault-free twin exactly
    kw = dict(budget=5, seed=9, n_init=3, executor="async", slots=2)
    clean_dir, killed_dir = tmp_path / "clean", tmp_path / "kills"
    clean_dir.mkdir()
    killed_dir.mkdir()
    clean = Study(_spec()).tune(
        objective=ts.KillNTimes(str(clean_dir), n=0), **kw)
    healed = Study(_spec()).tune(
        objective=ts.KillNTimes(str(killed_dir), n=1), pool="process", **kw)
    assert healed.n_failed == 0
    assert healed.best_value == clean.best_value
    assert _histories_equal(healed, clean)
    assert len(os.listdir(killed_dir)) == 1   # the kill really fired
    assert ts.MAX_POOL_REBUILDS == jts.executor.MAX_POOL_REBUILDS


# ---------------------------------------------------------------------------
# Study.tune(executor="async")
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ENGINES)
def test_async_slots1_equals_sync_bitwise(engine):
    kw = dict(budget=4, seed=9, n_init=3, space=_space_for(engine))
    r_sync = Study(_spec(engine)).tune(**kw)
    r_async = Study(_spec(engine)).tune(executor="async", slots=1, **kw)
    assert isinstance(r_async, ts.AsyncTuningResult)
    assert r_async.default_value == r_sync.default_value
    assert _histories_equal(r_sync, r_async)
    assert r_async.best.config == r_sync.best.config
    assert r_async.best_value == r_sync.best_value


def test_asha_journal_twins_and_epochs(tmp_path):
    kw = dict(budget=8, seed=9, n_init=3, executor="async", slots=2,
              scheduler="asha")
    j1, j2 = tmp_path / "thread.jsonl", tmp_path / "process.jsonl"
    r1 = Study(_spec()).tune(journal=str(j1), **kw)
    # the twin runs on process slots: the same bytes from another placement
    r2 = Study(_spec()).tune(journal=str(j2), pool="process", **kw)
    assert j1.read_bytes() == j2.read_bytes()
    assert r1.trials == r2.trials
    assert all(t["epochs_run"] in (15, 30, 60) for t in r1.trials)
    assert r1.n_stopped_early > 0
    assert 0.0 < r1.asha_epochs_saved_frac < 1.0
    assert r1.best_row["epochs_run"] == 60
    # promoted trials resumed from their carry: each epoch simulated once
    assert r1.epochs_evaluated == r1.epochs_committed + 60
    for t in r1.trials:
        if t["epochs_run"] < 60:
            assert t["told_value"] == pytest.approx(
                t["value"] * 60 / t["epochs_run"])
    _schema_ok(j1, j2)


def test_resume_torn_and_complete_journals(tmp_path, monkeypatch):
    kw = dict(budget=8, seed=9, n_init=3, executor="async", slots=3,
              scheduler="asha")
    full, torn = tmp_path / "full.jsonl", tmp_path / "torn.jsonl"
    r1 = Study(_spec()).tune(journal=str(full), **kw)
    raw = full.read_bytes()
    lines = raw.split(b"\n")
    torn.write_bytes(b"\n".join(lines[:-7]) + b"\n" + lines[-7][:10])
    r2 = Study(_spec()).tune(journal=str(torn), resume=True, **kw)
    assert torn.read_bytes() == raw
    assert r2.trials == r1.trials and r2.resumed
    assert r2.best.config == r1.best.config

    def no_eval(payload):
        raise AssertionError("a complete journal must not re-evaluate")

    monkeypatch.setattr(svc, "_eval_segment", no_eval)
    r3 = Study(_spec()).tune(journal=str(full), resume=True, **kw)
    assert full.read_bytes() == raw
    assert r3.trials == r1.trials and r3.best_value == r1.best_value
    assert r3.epochs_evaluated == 0
    _schema_ok(full, torn)


def test_tune_refusals(tmp_path):
    study = Study(_spec())
    j = str(tmp_path / "j.jsonl")
    study.tune(budget=3, seed=9, n_init=2, executor="async", journal=j)
    with pytest.raises(ValueError, match="diverged"):
        Study(_spec()).tune(budget=5, seed=9, n_init=2, executor="async",
                            journal=j, resume=True)
    with pytest.raises(ValueError, match="journal"):
        study.tune(budget=2, executor="async", resume=True)
    with pytest.raises(ValueError, match="executor='async'"):
        study.tune(budget=2, slots=4)
    with pytest.raises(ValueError, match="slots=N"):
        study.tune(budget=2, executor="async", batch_size=4)
    with pytest.raises(ValueError, match="scheduler='asha'"):
        study.tune(budget=2, executor="async", scheduler="asha",
                   objective=lambda c: 0.0)
    with pytest.raises(ValueError, match="unknown scheduler"):
        study.tune(budget=2, executor="async", scheduler="hyperband")
    with pytest.raises(ValueError, match="unknown executor"):
        study.tune(budget=2, executor="ray")
    # the socket pool is the fleet's: async slots refuse it as the
    # reference's executor does
    with pytest.raises(ValueError, match="unknown pool"):
        study.tune(budget=2, executor="async", pool="socket")
    with pytest.raises(RuntimeError, match="default-config baseline"):
        study.tune(budget=2, executor="async",
                   objective=lambda c: 1 / 0)
    _schema_ok(j)


def test_failed_trial_is_retried_then_journaled(tmp_path):
    calls = {"n": 0}

    def obj(cfg):
        calls["n"] += 1
        if calls["n"] in (2, 3):       # trial 0's attempt and its retry
            raise RuntimeError("injected persistent fault")
        return float(cfg["sampling_period"])

    j = tmp_path / "fail.jsonl"
    r = Study(_spec()).tune(budget=4, seed=9, n_init=3, executor="async",
                            slots=1, objective=obj, journal=str(j))
    assert r.n_failed == 1 and len(r.history) == 3
    kinds = [e["event"] for e in ts.read_events(str(j))]
    assert kinds.count("retry") == 1 and kinds.count("fail") == 1
    assert kinds.index("retry") < kinds.index("fail")
    _schema_ok(j)


_KILL_SCRIPT = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.core import ExperimentSpec, SimOptions, Study, WorkloadSpec
spec = ExperimentSpec(
    engine="hemem",
    workload=WorkloadSpec("gups", "8GiB-hot", threads=8, scale={scale!r}),
    options=SimOptions(seed=3, crn=True, device="cpu"))
if __name__ == "__main__":
    Study(spec).tune(journal={journal!r}, **{kw!r})
"""


def test_sigkill_then_resume_matches_the_uninterrupted_twin(tmp_path):
    j_twin = tmp_path / "twin.jsonl"
    r_twin = Study(_spec()).tune(journal=str(j_twin), **KILL_KW)
    j_kill = tmp_path / "killed.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILL_SCRIPT.format(
            src=str(ROOT / "src"), scale=SCALE, journal=str(j_kill),
            kw=KILL_KW)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while time.time() < deadline and proc.poll() is None:
            if j_kill.exists() and \
                    len(j_kill.read_bytes().splitlines()) >= 20:
                break
            time.sleep(0.005)
        else:
            pytest.fail("the killed study never reached 20 events: "
                        + proc.stderr.read().decode()[-2000:])
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
        proc.stderr.close()
    killed = ts.read_events(str(j_kill))
    assert 0 < len(killed) < len(ts.read_events(str(j_twin)))
    r_res = Study(_spec()).tune(journal=str(j_kill), resume=True, **KILL_KW)
    assert j_kill.read_bytes() == j_twin.read_bytes()
    assert r_res.trials == r_twin.trials
    assert _histories_equal(r_twin, r_res)
    _schema_ok(j_kill, j_twin)


def test_async_against_the_reference():
    # budget <= n_init: every asked config is the optimizer's own (no
    # model phase), so both packages ask the same configs
    kw = dict(budget=6, seed=0, n_init=6, executor="async", slots=2)
    ours = Study(_spec()).tune(**kw)
    ref = JaxStudy(_jax_spec()).tune(**kw)
    assert [t["config"] for t in ours.trials] == \
        [t["config"] for t in ref.trials]
    assert [t["group"] for t in ours.trials] == \
        [t["group"] for t in ref.trials]
    assert abs(ours.best_value - ref.best_value) <= 0.01 * ref.best_value
    assert abs(ours.default_value - ref.default_value) \
        <= TOTAL_RTOL * ref.default_value
