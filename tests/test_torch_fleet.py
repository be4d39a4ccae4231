"""The port's fault-tolerant fleet on the CPU: ``Study.tune(executor=
"fleet")`` against the port's ``executor="async"``.

``tests/test_tune_service_fleet.py``'s bars, at gups scale 0.02 (655
pages, 60 epochs) with ``device="cpu"``:

* fleet == async bitwise (trials, history, incumbent, default) on both
  pools, with and without ASHA; under ASHA the fleet re-derives each
  promoted trial's prefix (no carry crosses the transport), so it
  evaluates the promotions' epochs again;
* the fault matrix (kill, stall, drop, dup, delay) gives byte-identical
  journal twins with the reference's expire reasons (none for dup), and a
  death promotes the hot spare;
* a coordinator that was itself away (stalled between reading its inbox
  and judging its leases, or between two reads) expires no lease of a
  worker that kept heartbeating, and a worker killed while it writes to
  the coordinator silences no other worker;
* the argument checks of the reference.

The network faults, hangs, surrender and degradation are in
``tests/test_torch_fleet_net.py``; resume, the SIGKILLed coordinator, the
reference's fleet, the kernel-launch receipt and the launcher in
``tests/test_torch_fleet_resume.py`` (three files, so that xdist's
``--dist loadfile`` spreads them).  Each fleet stops its workers when the
study ends, also on error; every wait has a deadline.
"""

import time

import pytest

pytest.importorskip("torch")

from _torch_fleet_common import bounded_test  # noqa: E402,F401
from _torch_fleet_common import (ASHA_KW, FLEET_KW, KW,  # noqa: E402
                                 WAIT_S, same_study, schema_ok, spec)
from repro_torch.core import Study  # noqa: E402
from repro_torch.core.tune_service import (FaultPlan,  # noqa: E402
                                           FleetExecutor, FleetSpec,
                                           read_events)


@pytest.fixture(scope="module")
def baseline():
    """The port's async twin every fleet run must reproduce bitwise."""
    return Study(spec()).tune(executor="async", slots=2, **KW)


@pytest.fixture(scope="module")
def asha_baseline():
    return Study(spec()).tune(executor="async", slots=2, **ASHA_KW)


# ---------------------------------------------------------------------------
# placement invariance: fleet == async, both pools, with and without ASHA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pool", ["process", "socket"])
def test_fleet_matches_async(pool, baseline):
    r = Study(spec()).tune(executor="fleet", workers=2, pool=pool,
                           **KW, **FLEET_KW)
    same_study(r, baseline)
    fs = r.fleet
    assert fs["pool"] == pool and fs["workers"] == 2
    assert fs["n_expired_leases"] == 0 and fs["n_worker_deaths"] == 0
    assert fs["n_duplicate_results"] == 0 and not fs["degraded"]
    # on the CPU every kernel call takes its plain version: no launch
    assert fs["kernel_launches"]["select_topk"] == {"block": 0,
                                                    "cluster": 0}
    assert baseline.fleet is None


@pytest.mark.parametrize("pool", ["process", "socket"])
def test_fleet_asha_matches_async_asha(pool, asha_baseline, tmp_path):
    j = tmp_path / "asha.jsonl"
    r = Study(spec()).tune(executor="fleet", workers=2, pool=pool,
                           journal=str(j), **ASHA_KW, **FLEET_KW)
    same_study(r, asha_baseline)
    assert r.epochs_committed == asha_baseline.epochs_committed
    assert r.asha_epochs_saved_frac > 0  # rungs actually stopped trials
    # no carry crosses the transport: each promotion re-derives [0, hi),
    # where the async slots resumed from the rung's carry
    promoted = sum(t["epochs_run"] - 15 for t in r.trials
                   if t["epochs_run"] > 15)
    rederived = sum(15 if t["epochs_run"] == 30 else 15 + 30
                    for t in r.trials if t["epochs_run"] > 15)
    assert promoted > 0
    assert asha_baseline.epochs_evaluated == r.epochs_committed + 60
    assert r.epochs_evaluated == asha_baseline.epochs_evaluated + rederived
    header = read_events(str(j))[0]
    assert header["executor"] == "fleet"
    assert header["lease_deadline"] == FLEET_KW["lease_deadline"]
    schema_ok(j)


# ---------------------------------------------------------------------------
# the fault matrix: every injector, journal twins byte-identical
# ---------------------------------------------------------------------------
FAULT_CASES = {
    # injector -> (plan, expected expire reason or None)
    "kill": (FaultPlan(kill=[(2, 0)]), "worker-dead"),
    "stall": (FaultPlan(stall=[(2, 0)]), "expired"),
    "drop": (FaultPlan(drop=[(2, 0)]), "lost"),
    "dup": (FaultPlan(dup=[(2, 0)]), None),
    # late by more than the 2 s lease deadline
    "delay": (FaultPlan(delay=[(2, 0, 3.0)]), "expired"),
}


@pytest.mark.parametrize("injector", sorted(FAULT_CASES))
def test_fleet_journal_twins_under_fault(injector, baseline, tmp_path):
    plan, reason = FAULT_CASES[injector]
    runs, paths = [], []
    for twin in range(2):
        j = tmp_path / f"{injector}{twin}.jsonl"
        runs.append(Study(spec()).tune(executor="fleet", workers=2,
                                       faults=plan, journal=str(j),
                                       **KW, **FLEET_KW))
        paths.append(j)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    for r in runs:  # the fault cost re-execution, never a decision
        same_study(r, baseline)
    events = read_events(str(paths[0]))
    expires = [e for e in events if e["event"] == "expire"]
    reissues = [e for e in events if e["event"] == "reissue"]
    if reason is None:  # dup: the twin is absorbed, no lease ever expires
        assert not expires and not reissues
        assert runs[0].fleet["n_duplicate_results"] >= 1
    else:
        assert [e["reason"] for e in expires] == [reason]
        assert [(e["unit"], e["attempt"]) for e in expires] == [(2, 0)]
        assert [(e["unit"], e["attempt"]) for e in reissues] == [(2, 1)]
    if injector == "kill":
        # the death refilled the slot from the booted hot spare
        fs = runs[0].fleet
        assert fs["n_worker_deaths"] == 1 and fs["n_respawns"] == 1
        assert fs["n_spare_promotions"] == 1
    schema_ok(paths[0])


# ---------------------------------------------------------------------------
# silence is judged on the coordinator's listening, not its wall clock
# ---------------------------------------------------------------------------
def slow_unit(s):
    """A unit that runs ``s`` seconds while its worker heartbeats
    (module-level so a spawned worker imports it)."""
    time.sleep(s)
    return {"value": float(s)}


@pytest.mark.parametrize("where", ["_check_workers", "_pump"])
def test_coordinator_stall_expires_no_live_lease(where, monkeypatch):
    """The coordinator away for three times a lease's silence while its
    one worker heartbeats a 3 s unit: inside a pump (between reading the
    inbox and judging the leases, where a respawn or a descheduled host
    stalls it) or between two pumps.  No lease expires, no unit runs
    twice; judged on the wall clock, the first case expired the lease."""
    heartbeat_s, deadline = 0.05, 10
    stall_s = 3 * heartbeat_s * deadline
    ex = FleetExecutor(workers=1, pool="process", heartbeat_s=heartbeat_s,
                       lease_deadline=deadline, device="cpu")
    own = getattr(FleetExecutor, where)
    stalled = []

    def stalling(self, *args, **kw):
        if self._leases and not stalled:
            time.sleep(1.0)  # the lease has been heard from a while
            stalled.append(time.monotonic())
            time.sleep(stall_s)
        return own(self, *args, **kw)
    monkeypatch.setattr(FleetExecutor, where, stalling)
    try:
        ex.submit(slow_unit, 3.0)
        _, r = ex.pop_next()
        assert r["value"] == 3.0
        assert stalled
        st = ex.stats()
        assert st["n_expired_leases"] == 0 and st["n_reissues"] == 0
        assert st["n_duplicate_results"] == 0
    finally:
        ex.close()


def test_idle_heartbeat_crossing_its_unit_expires_nothing():
    """An idle heartbeat the worker sent before it received its unit, read
    when the lease is four heartbeats old (a loaded coordinator reads its
    inbox late), is not a lost result: nothing expires, and the unit is
    not re-issued to its busy worker.  Read as "idle", it expired the
    lease as ``lost``, and the re-issue came back "worker busy"."""
    ex = FleetExecutor(workers=1, pool="process", **FLEET_KW, device="cpu")
    try:
        seq = ex.submit(slow_unit, 1.0)
        deadline = time.monotonic() + WAIT_S
        while seq not in ex._leases:
            assert time.monotonic() < deadline, "no worker took the unit"
            ex._pump(block=True)
        wid = ex._leases[seq]["worker"]
        time.sleep(4 * ex.heartbeat_s)
        ex._handle({"type": "heartbeat", "worker": wid, "unit": None,
                    "attempt": None, "last": None})
        assert seq in ex._leases and ex.n_expired == 0
        _, r = ex.pop_next()
        assert r["value"] == 1.0
        st = ex.stats()
        assert st["n_expired_leases"] == 0 and st["n_reissues"] == 0
        assert st["n_duplicate_results"] == 0
    finally:
        ex.close()


def test_unit_frame_lost_with_its_connection_expires_lost():
    """The socket connection drops with a unit frame in it, after the
    write returned: the worker never receives the unit.  It re-greets on
    a new connection, and its first idle heartbeat there (which names no
    receipt of the unit) expires the lease as ``lost``, within heartbeats
    rather than at the 40 s silence deadline; the re-issue completes."""
    ex = FleetExecutor(workers=1, pool="socket", heartbeat_s=0.05,
                       lease_deadline=40, device="cpu")
    fleet = ex._fleet
    real_send = fleet.send
    dropped = []

    def send(wid, msg):
        if msg.get("type") == "unit" and not dropped:
            dropped.append((msg["unit"], msg["attempt"]))
            with fleet._lock:
                chan, conn = fleet._chans[wid], fleet._conn_ids[wid]
            chan.close()  # the frame never reaches the worker
            return conn
        return real_send(wid, msg)

    fleet.send = send
    try:
        seq = ex.submit(slow_unit, 0.2)
        _, r = ex.pop_next()
        assert r["value"] == 0.2
        assert dropped == [(seq, 0)]
        expiries = [h for h in ex._history[seq] if h["event"] == "expire"]
        assert expiries == [{"event": "expire", "unit": seq, "attempt": 0,
                             "reason": "lost"}]
        # issue to expiry: the re-dial, the greet and a heartbeat
        assert len(ex.recover_s) == 1
        assert ex.recover_s[0] < ex.lease_deadline / 4
        st = ex.stats()
        assert st["n_expired_leases"] == 1 and st["n_reissues"] == 1
        assert not st["degraded"]
    finally:
        ex.close()


def die_holding_its_outbox(marker):
    """First call: die as a worker killed mid-write dies, holding the
    write lock of the queue its worker sends on; later calls: 1.0
    (module-level so a spawned worker imports it)."""
    import gc
    import multiprocessing.queues as mq
    import os
    if os.path.exists(marker):
        return {"value": 1.0}
    open(marker, "w").close()
    for q in [o for o in gc.get_objects() if isinstance(o, mq.Queue)]:
        if q._thread is not None:  # a queue this process has written to
            q._wlock.acquire()
    os._exit(9)


def test_worker_killed_mid_write_silences_no_other(tmp_path):
    """Two workers: one runs a 4 s unit, the other dies holding its
    outbox's write lock.  The death expires its own lease only: the other
    worker's heartbeats and result still arrive, the promoted spare runs
    the re-issue, and the fleet does not degrade."""
    ex = FleetExecutor(workers=2, pool="process", heartbeat_s=0.05,
                       lease_deadline=40, device="cpu")
    try:
        ex.submit(slow_unit, 4.0)
        ex.submit(die_holding_its_outbox, str(tmp_path / "died"))
        got = [ex.pop_next()[1] for _ in range(2)]
        assert [r["value"] for r in got] == [4.0, 1.0]
        st = ex.stats()
        assert st["n_worker_deaths"] == 1
        assert st["n_expired_leases"] == 1
        assert not st["degraded"]
    finally:
        ex.close()


# ---------------------------------------------------------------------------
# argument validation
# ---------------------------------------------------------------------------
def test_fleet_rejects_bad_arguments():
    with pytest.raises(ValueError, match="workers"):
        FleetExecutor(workers=0)
    with pytest.raises(ValueError, match="pool"):
        FleetExecutor(workers=1, pool="carrier-pigeon")
    with pytest.raises(ValueError, match="lease_deadline"):
        FleetExecutor(workers=1, lease_deadline=0)
    with pytest.raises(ValueError, match="socket fleet"):
        FleetExecutor(workers=1, pool="process",
                      fleet_spec=FleetSpec.generate())
    study = Study(spec())
    with pytest.raises(ValueError, match="executor"):
        study.tune(budget=2, workers=2)  # sync path: no fleet knobs
    with pytest.raises(ValueError, match="fleet_spec"):
        study.tune(budget=2, fleet_spec=FleetSpec.generate())
    with pytest.raises(ValueError, match="fleet_spec"):
        study.tune(budget=2, executor="async",
                   fleet_spec=FleetSpec.generate())
    with pytest.raises(ValueError, match="unknown pool"):
        study.tune(budget=2, executor="async", pool="socket")
