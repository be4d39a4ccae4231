"""The readers of the program's spans (``metrics/_span_math.py`` and the
six metrics on it) on synthetic traces, and one traced whole run on the
CPU: its host events hold the program's spans, and with no device events
every reader finds nothing to read."""

import pytest
import torch

from tierbench import bench, load
from tierbench.metrics import _span_math as sm
from tierbench.tests.cpu import cpu_run

MS = 1e6  # ns
IDLE = ["idle_traces_pct.sim", "idle_engine_setup_pct.sim",
        "idle_epoch_loop_pct.sim", "idle_results_pct.sim"]
READERS = IDLE + ["epoch_host_ms.sim", "observe_launches_per_epoch.sim"]
SPANS = ["repro_torch.study.run", "repro_torch.workload.build",
         "repro_torch.sim.trace_upload", "repro_torch.sim.engine_setup",
         "repro_torch.sim.epoch", "repro_torch.sim.epoch.first_touch",
         "repro_torch.sim.epoch.observe", "repro_torch.sim.epoch.plan",
         "repro_torch.sim.epoch.select", "repro_torch.sim.epoch.cost",
         "repro_torch.sim.results"]


def _ms(*rows):
    return [(n, s * MS, e * MS) for n, s, e in rows]


def _trace(device=True, host=True):
    """A window of 1 s; the device busy over 0-100, 150-200, 400-900 ms
    (idle 350 ms); a pass's spans and runtime calls on the host."""
    dev = _ms(("k", 0, 100), ("k", 150, 200), ("k", 400, 900),
              ("k", 990, 1200)) if device else []
    spans = _ms(
        ("tierbench.pass", 0, 1000),
        ("repro_torch.study.run", 0, 950),
        ("repro_torch.workload.build", 0, 120),
        ("repro_torch.sim.trace_upload", 120, 160),
        ("repro_torch.sim.engine_setup", 160, 250),
        ("repro_torch.sim.epoch", 250, 300),
        ("repro_torch.sim.epoch.observe", 255, 280),
        ("repro_torch.sim.epoch.plan", 280, 290),
        ("repro_torch.sim.epoch", 300, 320),
        ("repro_torch.sim.epoch.observe", 301, 310),
        ("repro_torch.sim.epoch", 320, 350),
        ("repro_torch.sim.epoch.observe", 321, 330),
        ("repro_torch.sim.results", 350, 420),
        ("repro_torch.sim.results", 940, 990),
        ("repro_torch.sim.epoch", 1100, 1300))  # past the window
    calls = _ms(
        ("cudaLaunchKernel", 256, 257), ("cudaMemcpyAsync", 260, 261),
        ("aten::mul", 262, 263), ("cudaStreamSynchronize", 264, 265),
        ("cudaLaunchKernel", 282, 283),  # in plan: not counted
        ("cuLaunchKernel", 302, 303), ("cudaMemsetAsync", 322, 323),
        ("cudaLaunchKernelExC", 329, 329.5),
        ("cudaLaunchKernel", 340, 341))  # in an epoch, not in observe
    return {"device": dev, "host": (spans + calls) if host else [],
            "window": (0, 1000 * MS), "shapes": {"epochs": 3}}


def _read(name, trace):
    return load("metrics", name).read(trace)


def test_interval_arithmetic():
    assert sm.merged([(5, 7), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 7)]
    assert sm.overlap_ns([(0, 4), (5, 7)], [(3, 6), (6.5, 10)]) == 2.5
    assert sm.overlap_ns([], [(0, 1)]) == 0.0


def test_idle_shares_are_gaps_inside_each_layers_spans():
    tr = _trace()
    # gaps 100-150 (traces), 200-400 (50 set-up, 100 epochs, 50 results),
    # 900-990 (40 outside every span, 50 results)
    assert _read("idle_traces_pct.sim", tr) == pytest.approx(5.0)
    assert _read("idle_engine_setup_pct.sim", tr) == pytest.approx(5.0)
    assert _read("idle_epoch_loop_pct.sim", tr) == pytest.approx(10.0)
    assert _read("idle_results_pct.sim", tr) == pytest.approx(10.0)
    assert _read("device_idle_pct.sim", tr) == pytest.approx(34.0)


def test_idle_shares_count_no_time_twice():
    tr = _trace()
    parts = sum(_read(m, tr) for m in IDLE)
    every = sm.idle_pct(tr, ["repro_torch.workload.build",
                             "repro_torch.sim.trace_upload",
                             "repro_torch.sim.engine_setup",
                             "repro_torch.sim.epoch",
                             "repro_torch.sim.results"])
    assert parts == pytest.approx(every)
    assert parts <= _read("device_idle_pct.sim", tr)


def test_epoch_host_ms_is_the_median_epoch_span():
    # epochs of 50, 20, 30 ms in the window; the one past it is left out
    assert _read("epoch_host_ms.sim", _trace()) == pytest.approx(30.0)


def test_observe_launches_count_runtime_calls_inside_observe():
    # 256, 260, 302, 322, 329 start in observe spans; aten::mul and the
    # synchronize are no launch; 282 is in plan, 340 outside observe
    assert _read("observe_launches_per_epoch.sim", _trace()) == \
        pytest.approx(5 / 3)


@pytest.mark.parametrize("reader", READERS)
def test_readers_find_nothing_without_device_or_spans(reader):
    assert _read(reader, _trace()) is not None
    assert _read(reader, _trace(device=False)) is None
    assert _read(reader, _trace(host=False)) is None


def test_traced_cpu_run_holds_the_spans_and_no_reading(monkeypatch):
    from tierbench import generate
    full = generate.pass_configs
    monkeypatch.setattr(generate, "pass_configs",
                        lambda *a: full(*a)[:-1:8] + full(*a)[-1:])
    monkeypatch.setattr(bench, "TRACED_PASSES", 1)
    kept = {}
    traced_passes = bench.traced_passes

    def keep(driver, passes):
        kept.update(traced_passes(driver, passes))
        return kept
    monkeypatch.setattr(bench, "traced_passes", keep)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = cpu_run("gapbs-pr-hmsdk.sweep", 2 ** 33 + 5, trace=True,
                    setattr_=monkeypatch.setattr)
    finally:
        torch.set_num_threads(threads)
    assert r["correct"] is True and r["metrics"] == {}
    assert set(SPANS) <= {name for name, _, _ in kept["host"]}
    assert kept["device"] == []
    for reader in READERS:
        assert _read(reader, kept) is None
