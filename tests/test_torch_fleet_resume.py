"""The port's fleet on the CPU: resume, the reference's fleet, the
kernel-launch receipt and the launcher (``tests/test_tune_service_fleet.py``'s
cases; the shape and the checks of ``tests/test_torch_fleet.py``).

* a torn journal, and a coordinator SIGKILLed mid-run after a re-issue,
  resume byte-identically to an uninterrupted twin; ASHA composes with
  the fault plan (journal twins, the async ASHA study bitwise);
* the lease history (``lease``/``expire``/``reissue`` with unit, attempt
  and reason) under the ``kill`` and ``drop`` plans equals the reference
  fleet's (``backend="numpy"``, as its own tests run it);
* the workers' kernel launches are summed into the receipt and stripped
  from the results; a worker that cannot start its device fails its
  units (no fallback to the CPU), and so does a worker given units for
  another device than the one it warmed up;
* ``python -m repro_torch.launch.fleet``: ``--init`` writes a 0600 spec,
  ``--print`` prints keyless per-host commands, and local mode brings up
  workers that greet a coordinator bound to the spec, the key never on
  argv nor in the journal.

Every subprocess has a deadline and is stopped in ``finally``.
"""

import os
import shutil
import signal
import subprocess
import sys
import time

import pytest

pytest.importorskip("torch")

from _torch_fleet_common import bounded_test  # noqa: E402,F401
from _torch_fleet_common import (ASHA_KW, FLEET_KW, KW, ROOT,  # noqa: E402
                                 SCALE, WAIT_S, lease_history, same_study,
                                 schema_ok, spec)
from repro_torch.core import Study  # noqa: E402
from repro_torch.core.tune_service import (FaultPlan,  # noqa: E402
                                           FleetExecutor, FleetSpec,
                                           read_events, tear_journal)
from repro_torch.core.tune_service.worker import (KEY_ENV,  # noqa: E402
                                                  LAUNCHES_KEY,
                                                  device_error, warm_up)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import select_topk as sk  # noqa: E402
from repro_torch.launch import fleet as launcher  # noqa: E402

SRC = ROOT / "src"


# ---------------------------------------------------------------------------
# resume: a torn journal, and a SIGKILLed coordinator mid-faulty-run
# ---------------------------------------------------------------------------
def test_fleet_resume_from_torn_journal(tmp_path):
    kw = dict(executor="fleet", workers=2,
              faults=FaultPlan(kill=[(2, 0)], drop=[(4, 0)]),
              **KW, **FLEET_KW)
    full, torn = tmp_path / "full.jsonl", tmp_path / "torn.jsonl"
    r1 = Study(spec()).tune(journal=str(full), **kw)
    shutil.copy(full, torn)
    tear_journal(str(torn), 9)
    r2 = Study(spec()).tune(journal=str(torn), resume=True, **kw)
    assert torn.read_bytes() == full.read_bytes()
    assert r2.trials == r1.trials and r2.resumed
    assert r2.best_value == r1.best_value
    schema_ok(full)


#: the killed coordinator: kill every 4th unit's first attempt, respawn
SIGKILL_KW = dict(budget=12, seed=9, n_init=4, executor="fleet", workers=2,
                  max_respawns=24, **FLEET_KW)
_KILL_SCRIPT = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.core import ExperimentSpec, SimOptions, Study, WorkloadSpec
from repro_torch.core.tune_service import FaultPlan
spec = ExperimentSpec(
    engine="hemem",
    workload=WorkloadSpec("gups", "8GiB-hot", threads=8, scale={scale!r}),
    options=SimOptions(seed=3, crn=True, device="cpu"))
if __name__ == "__main__":
    Study(spec).tune(journal={journal!r}, faults=FaultPlan(kill_every=4),
                     **{kw!r})
"""


def test_fleet_coordinator_sigkill_resume_is_byte_identical(tmp_path):
    faults = FaultPlan(kill_every=4)
    j_twin = tmp_path / "twin.jsonl"
    r_twin = Study(spec()).tune(journal=str(j_twin), faults=faults,
                                **SIGKILL_KW)
    j_kill = tmp_path / "killed.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILL_SCRIPT.format(
            src=str(SRC), scale=SCALE, journal=str(j_kill), kw=SIGKILL_KW)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        # SIGKILL once a re-issue is journaled (a lease history is
        # journaled at its unit's commit), so the resume replays one and
        # continues into live ones
        deadline = time.time() + 50
        while time.time() < deadline and proc.poll() is None:
            if j_kill.exists():
                raw = j_kill.read_bytes()
                if raw.count(b'"event": "reissue"') >= 1 and \
                        len(raw.splitlines()) >= 15:
                    break
            time.sleep(0.01)
        else:
            pytest.fail("the killed study never journaled a re-issue: "
                        + proc.stderr.read().decode()[-2000:])
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=WAIT_S)
        proc.stderr.close()
    assert 0 < len(read_events(str(j_kill))) < len(read_events(str(j_twin)))
    r_res = Study(spec()).tune(journal=str(j_kill), resume=True,
                               faults=faults, **SIGKILL_KW)
    assert j_kill.read_bytes() == j_twin.read_bytes()
    same_study(r_res, r_twin)
    assert r_twin.fleet["n_worker_deaths"] == 4  # units 0, 4, 8 and 12
    schema_ok(j_twin)


def test_fleet_asha_journal_twins_under_faults(tmp_path):
    # promotion and early stop compose with a killed worker and a dropped
    # result mid-rung: re-execution, never a different rung decision
    base = Study(spec()).tune(executor="async", slots=2, **ASHA_KW)
    plan = FaultPlan(kill=[(2, 0)], drop=[(4, 0)])
    paths = []
    for twin in range(2):
        j = tmp_path / f"asha{twin}.jsonl"
        r = Study(spec()).tune(executor="fleet", workers=2, faults=plan,
                               journal=str(j), **ASHA_KW, **FLEET_KW)
        same_study(r, base)
        paths.append(j)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert [(e["unit"], e["reason"]) for e in read_events(str(paths[0]))
            if e["event"] == "expire"] == [(2, "worker-dead"), (4, "lost")]
    schema_ok(paths[0])


# ---------------------------------------------------------------------------
# the reference fleet: the same lease history under kill and drop
# ---------------------------------------------------------------------------
REF_CASES = {"kill": "worker-dead", "drop": "lost"}


@pytest.mark.parametrize("injector", sorted(REF_CASES))
def test_lease_history_equals_the_reference(injector, tmp_path):
    # the reference spawns its workers once jax is imported (it forks
    # otherwise, and this process holds torch's threads)
    pytest.importorskip("jax")
    from repro.core import ExperimentSpec as RefSpec
    from repro.core import SimOptions as RefOptions
    from repro.core import Study as RefStudy
    from repro.core import WorkloadSpec as RefWorkload
    from repro.core.tune_service import FaultPlan as RefPlan
    ours, ref = tmp_path / "ours.jsonl", tmp_path / "ref.jsonl"
    Study(spec()).tune(executor="fleet", workers=2,
                       faults=FaultPlan(**{injector: [(2, 0)]}),
                       journal=str(ours), **KW, **FLEET_KW)
    ref_spec = RefSpec(engine="hemem",
                       workload=RefWorkload("gups", scale=SCALE),
                       options=RefOptions(backend="numpy"))
    RefStudy(ref_spec).tune(executor="fleet", workers=2,
                            faults=RefPlan(**{injector: [(2, 0)]}),
                            journal=str(ref), **KW, **FLEET_KW)
    hist = lease_history(ours)
    assert hist == lease_history(ref)
    assert [h for h in hist if h[0] != "lease"] == [
        ("expire", 2, 0, REF_CASES[injector]), ("reissue", 2, 1, None)]
    assert [h[1] for h in hist if h[0] == "lease"] == list(range(7))


# ---------------------------------------------------------------------------
# the card: launches summed and stripped; no fallback from a missing card
# ---------------------------------------------------------------------------
def count_launches(n):
    """A unit standing for ``n`` cluster launches on its worker (bumps the
    counter as the wrapper does; module-level so a spawned worker imports
    it)."""
    for _ in range(n):
        build.count_launch(sk, "cluster")
    return {"value": float(n)}


@pytest.mark.parametrize("pool", ["process", "socket"])
def test_worker_launches_are_summed_and_stripped(pool):
    ex = FleetExecutor(workers=2, pool=pool, heartbeat_s=0.05,
                       lease_deadline=40, device="cpu")
    try:
        for n in (3, 0, 5, 2):
            ex.submit(count_launches, n)
        got = [ex.pop_next()[1] for _ in range(4)]
        assert [r["value"] for r in got] == [3.0, 0.0, 5.0, 2.0]
        assert all(LAUNCHES_KEY not in r for r in got)
        assert ex.stats()["kernel_launches"]["select_topk"] == \
            {"block": 0, "cluster": 10}
    finally:
        ex.close()


def test_worker_without_its_device_fails_its_units():
    # a device the worker cannot start: the warm-up fails, the worker
    # still greets, and every unit returns that error (no CPU fallback)
    ex = FleetExecutor(workers=1, pool="process", heartbeat_s=0.05,
                       lease_deadline=40, device="cuda:99")
    try:
        ex.submit(count_launches, 1)
        _, r = ex.pop_next()
        assert "could not start cuda:99" in r["error"]
        assert "value" not in r
        assert ex.stats()["kernel_launches"] == {}
    finally:
        ex.close()
    assert warm_up("cpu", 0) is None
    assert "no kernel for device meta" in warm_up("meta", 4)


def on_device(payload):
    """A segment-shaped unit: its payload names the device it runs on."""
    return {"value": 1.0}


def test_socket_worker_refuses_units_for_another_device():
    """A ``--device cpu`` CLI worker of a fleet spec serves a study on
    ``cuda:99``: it warmed up the CPU, so it answers that study's units
    with an error result and runs only units for its own device."""
    fleet_spec = FleetSpec.generate(workers=1, hosts=("127.0.0.1",),
                                    heartbeat_s=0.05, lease_deadline=40)
    ex = FleetExecutor(workers=1, pool="socket", fleet_spec=fleet_spec,
                       device="cuda:99")
    host, port = ex._fleet.address
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.tune_service.worker",
         "--connect", f"{host}:{port}", "--id", "0", "--device", "cpu",
         "--heartbeat", "0.05", "--max-redials", "2"],
        env=dict(os.environ,
                 PYTHONPATH=os.pathsep.join((str(SRC), str(ROOT / "tests"))),
                 **{KEY_ENV: fleet_spec.auth_key}),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        ex.submit(on_device, {"device": "cuda:99"})
        ex.submit(on_device, {"device": "cpu"})
        (_, wrong), (_, right) = ex.pop_next(), ex.pop_next()
        assert "warmed up cpu, but its unit runs on cuda:99" in \
            wrong["error"] and "value" not in wrong
        assert right["value"] == 1.0
        assert not ex.stats()["degraded"]
    finally:
        ex.close()
        try:
            proc.wait(timeout=WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=WAIT_S)
    # the reverse, and the names of one device
    assert "warmed up cuda, but" in device_error(({"device": "cpu"},),
                                                 "cuda", 1)
    assert device_error(({"device": "cuda"},), "cuda:0", 1) is None
    assert device_error(({"value": 1},), "cpu", 1) is None
    assert device_error((), "cpu", 1) is None
    assert "runs on nowhere" in device_error(({"device": "nowhere"},),
                                             "cpu", 1)


# ---------------------------------------------------------------------------
# the launcher: python -m repro_torch.launch.fleet
# ---------------------------------------------------------------------------
def test_fleet_launch_init_and_print(tmp_path, capsys):
    path = str(tmp_path / "fleet.json")
    assert launcher.main([path, "--init", "--workers", "3",
                          "--hosts", "h1,h2,h3"]) == 0
    assert os.stat(path).st_mode & 0o777 == 0o600
    spec_ = FleetSpec.load(path)
    assert spec_.workers == 3 and spec_.external and spec_.port != 0
    capsys.readouterr()
    assert launcher.main([path, "--print", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for i, h in enumerate(("h1", "h2", "h3")):  # one keyless line a host
        assert f"{h}$ {launcher.worker_command(path, i, device='cpu')}" \
            in out
    assert "repro_torch.core.tune_service.worker" in out
    assert spec_.auth_key not in out
    # hosts default to the coordinator's (local mode); a spec without
    # hosts is the coordinator's own fleet, which the launcher refuses
    assert launcher.main([path, "--init", "--workers", "2"]) == 0
    assert FleetSpec.load(path).hosts == ("127.0.0.1", "127.0.0.1")
    FleetSpec.generate(workers=2, port=5555).save(path)
    assert launcher.main([path]) == 2


def _argv_of_workers():
    """The argv of every fleet worker process on this host (Linux)."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                argv = fh.read().replace(b"\0", b" ").decode()
        except OSError:
            continue
        if launcher.WORKER_MODULE in argv:
            out.append(argv)
    return out


@pytest.mark.skipif(not os.path.isdir("/proc"), reason="reads /proc")
def test_fleet_launcher_round_trip(tmp_path):
    """The multi-host shape on one host: a spec minted by the launcher's
    ``--init``, its local mode bringing up two CLI workers that dial and
    greet a coordinator bound to the spec's port (the key in the
    environment, never on argv) -- and the study bitwise the async one."""
    base = Study(spec()).tune(executor="async", slots=2, **KW)
    path = str(tmp_path / "fleet.json")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-m", "repro_torch.launch.fleet", path,
                    "--init", "--workers", "2"], env=env, check=True,
                   timeout=WAIT_S, capture_output=True)
    fleet_spec = FleetSpec.load(path)
    assert fleet_spec.external and os.environ.get(KEY_ENV) is None
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.fleet", path,
         "--device", "cpu", "--greet-timeout", "40"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 40
        argv = []
        while time.time() < deadline and len(argv) < 2:
            argv = _argv_of_workers()
            time.sleep(0.05)
        assert len(argv) >= 2
        assert not [a for a in argv if fleet_spec.auth_key in a]
        j = tmp_path / "fleet.jsonl"
        # the workers re-dial with backoff until the coordinator binds
        r = Study(spec()).tune(executor="fleet", fleet_spec=fleet_spec,
                               journal=str(j), **KW)
        out, _ = proc.communicate(timeout=WAIT_S)  # shutdown ends the fleet
    finally:
        if proc.poll() is None:  # SIGTERM: the launcher stops its workers
            proc.terminate()
            try:
                proc.communicate(timeout=WAIT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate(timeout=WAIT_S)
    assert proc.returncode == 0, out
    assert "all 2 workers greeted" in out and "fleet stopped" in out
    same_study(r, base)
    assert r.fleet["pool"] == "socket" and not r.fleet["degraded"]
    assert r.fleet["n_expired_leases"] == 0
    # the journal never saw the fleet's secret
    assert fleet_spec.auth_key.encode() not in j.read_bytes()
    schema_ok(j)
