"""Shared shape and checks of the port's fleet tests
(``tests/test_torch_fleet*.py``): the study they run, on the CPU, how
they compare two studies and validate a journal, and the bound on each
test's waits."""

import signal
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from repro_torch.core import ExperimentSpec, SimOptions, WorkloadSpec
from repro_torch.core.tune_service import read_events

ROOT = Path(__file__).resolve().parents[1]
#: gups at scale 0.02: 655 pages, 60 epochs
SCALE = 0.02
#: common study shape: budget 6 = units 1..6, unit 0 is the default config
KW = dict(budget=6, seed=9, n_init=3)
ASHA_KW = dict(KW, scheduler="asha")
#: tight heartbeats, and a lease deadline of 2 s of silence: expiries land
#: fast, and a loaded test host does not expire a live lease
FLEET_KW = dict(heartbeat_s=0.05, lease_deadline=40)
#: the longest any one fleet test may run: a wait the test cannot bound
#: itself (a study's commit loop over its workers' results) fails the test
#: there instead of holding the whole run.  The longest took 64 s in a
#: whole run of the suite (six test workers on an 8-core host)
TEST_DEADLINE_S = 180
#: the bound of each subprocess call and each join or read the tests wait
#: on themselves
WAIT_S = 30


@pytest.fixture(autouse=True)
def bounded_test():
    """Raise ``TimeoutError`` in the test after ``TEST_DEADLINE_S`` (a
    ``SIGALRM``, where the test runs on the main thread); the test's
    ``finally`` blocks stop what it started.  Each fleet test module
    imports this fixture, which makes it apply there."""
    if threading.current_thread() is not threading.main_thread() or \
            not hasattr(signal, "SIGALRM"):
        yield
        return

    def expired(signum, frame):
        raise TimeoutError(f"the test ran past its {TEST_DEADLINE_S} s "
                           f"bound")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TEST_DEADLINE_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def spec():
    return ExperimentSpec(
        engine="hemem",
        workload=WorkloadSpec("gups", "8GiB-hot", threads=8, scale=SCALE),
        options=SimOptions(seed=3, crn=True, device="cpu"))


def histories_equal(a, b):
    return [(o.config, o.value) for o in a.history] == \
        [(o.config, o.value) for o in b.history]


def same_study(r, base):
    """``r`` made every decision ``base`` made, bitwise."""
    assert r.trials == base.trials
    assert histories_equal(r, base)
    assert r.best_value == base.best_value
    assert r.best.config == base.best.config
    assert r.default_value == base.default_value


def schema_ok(*paths):
    """``tools/journal_schema.py`` on each journal, as a subprocess."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "journal_schema.py"),
         *map(str, paths)], capture_output=True, text=True, timeout=WAIT_S)
    assert out.returncode == 0, out.stdout + out.stderr


def lease_history(path):
    """The journal's lease lifecycle: (event, unit, attempt, reason)."""
    return [(e["event"], e["unit"], e["attempt"], e.get("reason"))
            for e in read_events(str(path))
            if e["event"] in ("lease", "expire", "reissue")]
