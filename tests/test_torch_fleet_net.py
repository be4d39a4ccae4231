"""The port's fleet on the CPU under network faults, hangs and lost
workers (``tests/test_tune_service_fleet.py``'s cases; the shape and the
checks of ``tests/test_torch_fleet.py``).

* corrupt, truncate and replay on the socket transport give
  byte-identical journal twins, the reference's ``reject`` reasons
  (``bad-signature``, ``truncated``; none journaled for replay) and the
  port's async study bitwise;
* a partition on a result ends in a journaled ``reconnect``, nothing
  re-executed; link latency changes nothing;
* a hang is unwedged by ``timeout_s`` (one journaled retry), a unit whose
  result is lost four times is surrendered as a FAILED trial, and at zero
  live workers the coordinator runs units on its local slot.

Each fleet stops its workers when the study ends, also on error; every
wait has a deadline.
"""

import pytest

pytest.importorskip("torch")

from _torch_fleet_common import bounded_test  # noqa: E402,F401
from _torch_fleet_common import (FLEET_KW, KW, same_study,  # noqa: E402
                                 schema_ok, spec)
from repro_torch.core import Study  # noqa: E402
from repro_torch.core.tune_service import FaultPlan, read_events  # noqa: E402
from repro_torch.core.tune_service.trial import (FAILED,  # noqa: E402
                                                 TERMINATED)


@pytest.fixture(scope="module")
def baseline():
    """The port's async twin every fleet run must reproduce bitwise."""
    return Study(spec()).tune(executor="async", slots=2, **KW)


# ---------------------------------------------------------------------------
# network-shaped faults (socket transport): journal twins byte-identical
# ---------------------------------------------------------------------------
NET_FAULT_CASES = {
    # injector -> (plan, journaled reject reason or None)
    "corrupt": (FaultPlan(corrupt=[(2, 0)]), "bad-signature"),
    "truncate": (FaultPlan(truncate=[(2, 0)]), "truncated"),
    # a replayed VALID result: the first copy commits and releases the
    # lease before the replay is read, so the reject is stats only
    "replay": (FaultPlan(replay=[(2, 0)]), None),
}


@pytest.mark.parametrize("injector", sorted(NET_FAULT_CASES))
def test_socket_fleet_net_fault_journal_twins(injector, baseline, tmp_path):
    plan, reason = NET_FAULT_CASES[injector]
    runs, paths = [], []
    for twin in range(2):
        j = tmp_path / f"{injector}{twin}.jsonl"
        runs.append(Study(spec()).tune(
            executor="fleet", workers=2, pool="socket", faults=plan,
            journal=str(j), **KW, **FLEET_KW))
        paths.append(j)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    for r in runs:
        same_study(r, baseline)
        assert r.fleet["n_rejected_frames"] >= 1
    events = read_events(str(paths[0]))
    rejects = [e for e in events if e["event"] == "reject"]
    if reason is None:
        assert not rejects
        assert runs[0].fleet["n_duplicate_results"] == 0
    else:
        assert [(e["unit"], e["attempt"], e["reason"])
                for e in rejects] == [(2, 0, reason)]
        assert [(e["unit"], e["reason"]) for e in events
                if e["event"] == "expire"] == [(2, "reject")]
        assert [(e["unit"], e["attempt"]) for e in events
                if e["event"] == "reissue"] == [(2, 1)]
    schema_ok(paths[0])


def test_socket_fleet_reconnect_mid_lease(baseline, tmp_path):
    """A partition on unit 2's result: the worker re-dials and re-greets
    while its result waits; the coordinator re-attaches the live lease
    (``reconnect`` journaled at commit) and nothing is re-executed."""
    plan = FaultPlan(partition=[(2, 0, 0.2)])
    runs, paths = [], []
    for twin in range(2):
        j = tmp_path / f"part{twin}.jsonl"
        runs.append(Study(spec()).tune(
            executor="fleet", workers=2, pool="socket", faults=plan,
            journal=str(j), **KW, **FLEET_KW))
        paths.append(j)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    for r in runs:
        same_study(r, baseline)
        assert r.fleet["n_reconnects"] == 1
    events = read_events(str(paths[0]))
    assert [(e["unit"], e["attempt"]) for e in events
            if e["event"] == "reconnect"] == [(2, 0)]
    assert not [e for e in events if e["event"] in ("expire", "reissue")]
    assert runs[0].fleet["n_duplicate_results"] == 0


def test_socket_fleet_under_injected_latency(baseline):
    r = Study(spec()).tune(executor="fleet", workers=2, pool="socket",
                           faults=FaultPlan(net_delay_s=0.005),
                           **KW, **FLEET_KW)
    same_study(r, baseline)


# ---------------------------------------------------------------------------
# hangs, surrender, degradation
# ---------------------------------------------------------------------------
def test_fleet_hang_unwedged_by_timeout(baseline, tmp_path):
    # heartbeats keep flowing, the result never comes: only the per-unit
    # timeout unwedges it, and the bounded trial retry absorbs the loss
    j = tmp_path / "hang.jsonl"
    r = Study(spec()).tune(executor="fleet", workers=2,
                           faults=FaultPlan(hang=[(2, 0)]), timeout_s=6.0,
                           journal=str(j), **KW, **FLEET_KW)
    # the retry re-orders one tell (a journaled decision), so only the
    # incumbent is held to the fault-free study, as the reference holds it
    assert r.best_value == baseline.best_value and r.n_failed == 0
    retries = [e for e in read_events(str(j)) if e["event"] == "retry"]
    assert len(retries) == 1 and "timeout" in retries[0]["error"]
    schema_ok(j)


def test_fleet_surrenders_after_max_attempts(tmp_path):
    # unit 2 loses its result on every attempt: the lease expires
    # MAX_ATTEMPTS (4) times, the unit is surrendered, and with retries=0
    # the trial fails -- the study finishes, never wedges
    plan = FaultPlan(drop=[(2, 0), (2, 1), (2, 2), (2, 3)])
    j = tmp_path / "surrender.jsonl"
    r = Study(spec()).tune(executor="fleet", workers=2, faults=plan,
                           retries=0, journal=str(j), **KW, **FLEET_KW)
    states = [t["state"] for t in r.trials]
    assert states.count(FAILED) == 1 and states.count(TERMINATED) == 5
    failed = next(t for t in r.trials if t["state"] == FAILED)
    assert "lease expired 4 times" in failed["error"]
    events = read_events(str(j))
    assert [e["reason"] for e in events if e["event"] == "expire"] == \
        ["lost"] * 4
    assert len([e for e in events if e["event"] == "reissue"]) == 3
    schema_ok(j)


def test_fleet_degrades_to_local_at_zero_workers():
    # one worker, killed mid-unit, no respawn budget: every later unit
    # runs on the coordinator's local slot -- slower, never wedged, and
    # still bitwise (a unit is a pure function of its coordinates)
    r = Study(spec()).tune(executor="fleet", workers=1,
                           faults=FaultPlan(kill=[(1, 0)]), max_respawns=0,
                           **KW, **FLEET_KW)
    fs = r.fleet
    assert fs["degraded"] and fs["n_worker_deaths"] == 1
    assert fs["n_respawns"] == 0
    same_study(r, Study(spec()).tune(executor="async", slots=1, **KW))
