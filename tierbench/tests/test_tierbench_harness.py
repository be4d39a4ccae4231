"""Whole runs of the harness on the CPU at a small scale: a sound run is
correct; the command line refuses without a card; the process loads
neither JAX nor the JAX package; the trace readers' arithmetic."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tierbench import bench, load
from tierbench.metrics import _trace_math as tm
from tierbench.tests.cpu import cpu_run

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["gups-hemem.grid", "gapbs-pr-hmsdk.sweep"]


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small tensors: one thread is fastest
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def run_cpu(monkeypatch):
    def run(cell, seed=2 ** 32 + 11, trace=False):
        return cpu_run(cell, seed, trace, setattr_=monkeypatch.setattr)
    return run


@pytest.fixture
def thinned(monkeypatch):
    """Every eighth configuration of a pass and the last: the same run
    with an eighth of the work."""
    from tierbench import generate
    full = generate.pass_configs

    def thin(config, traffic, seed):
        cfgs = full(config, traffic, seed)
        return cfgs[:-1:8] + cfgs[-1:]
    monkeypatch.setattr(generate, "pass_configs", thin)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, one_thread, run_cpu):
    r = run_cpu(cell)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 65
    assert set(r["metrics"]) == {"sim_configs_per_s", "setup_s"}
    assert list(r)[-1] == "compared"
    for c in r["compared"].values():
        assert 0 <= c["value"] <= c["limit"]
    json.dumps(r)


def test_traced_run_on_cpu_reports_no_device_metric(one_thread, thinned,
                                                     monkeypatch, run_cpu):
    monkeypatch.setattr(bench, "TRACED_PASSES", 1)
    r = run_cpu("gups-hemem.grid", trace=True)
    assert r["correct"] is True
    assert r["metrics"] == {}  # the readers find no device activity
    assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0


def _cli(args, cwd, env=None):
    return subprocess.run([sys.executable, "-m", "tierbench.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_command_line_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _cli(["--workload", "gups-hemem.grid", "--seed", "3",
              "--seconds", "1", "--trace", "0"], ROOT, env)
    assert p.returncode != 0 and p.stdout == ""
    assert "torch.cuda.is_available() is False" in p.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "tierbench", tmp_path / "tierbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(["--workload", "gups-hemem.grid", "--seed", "3",
              "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "from tierbench import bench, calibrate, generate, load, run\n"
            "from tierbench.tests.cpu import cpu_run\n"
            "from tierbench.reference import core\n"
            "cell = bench.Cell('gups-hemem.grid')\n"
            "load('drivers', cell.config['driver'])\n"
            "for m in ('launches_per_epoch.sim', 'device_idle_pct.sim',\n"
            "          'select_topk_roofline.sim'):\n"
            "    load('metrics', m)\n"
            "import torch; torch.set_num_threads(1)\n"
            "r = cpu_run('gapbs-pr-hmsdk.sweep', 5, scale=0.002)\n"
            "assert r['correct']\n"
            "print(run.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "tierbench" / "reference").rglob("*.py"):
        text = path.read_text()
        assert "repro" not in text and "torch" not in text, path


def test_forbidden_names_compare_whole_top_level_names():
    from tierbench import run
    assert run.forbidden_modules(["repro_torch.core", "jaxlike", "flaxen",
                                  "torch", "reprox.y"]) == []
    assert run.forbidden_modules(["repro.core", "jax.numpy", "jaxlib",
                                  "flax.linen", "repro_torch"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def _trace(device, window, shapes=None):
    return {"device": device, "host": [], "window": window,
            "shapes": shapes or {}}


def test_trace_arithmetic():
    tr = _trace([("a", 0, 10), ("b", 5, 20), ("select_topk_x", 30, 40),
                 ("c", 90, 120)], (0, 100),
                {"epochs": 2, "select_topk": [(8, 32783)]})
    assert tm.busy_ns(tr) == 20 + 10 + 10
    assert tm.gaps(tr) == [(20, 30), (40, 90)]
    idle = load("metrics", "device_idle_pct.sim").read(tr)
    assert idle == pytest.approx(60.0)
    lpe = load("metrics", "launches_per_epoch.sim").read(tr)
    assert lpe == 2.0  # the event starting past the window is not counted
    assert tm.select_topk_cost(8, 32783) == (0, 3_147_232)
    roof = load("metrics", "select_topk_roofline.sim")
    share = roof.read(tr)
    assert share == pytest.approx(100 * 3_147_232 / 3.35e12 / 10e-9)
    assert roof.read(_trace([], (0, 1), {"select_topk": [(8, 9)]})) is None
    assert idle is not None and load(
        "metrics", "device_idle_pct.sim").read(_trace([], (0, 1))) is None
