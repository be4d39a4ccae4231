"""The simulator's host spans (``repro_torch.spans``) on the CPU: under
``torch.profiler`` a ``Study.run`` pass emits the documented span tree; with
no profiler recording it makes no ``record_function`` call; the results are
bitwise the same either way."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import ExperimentSpec, SimOptions, Study, WorkloadSpec
from repro_torch.core.knobs import get_space

CASES = {"hemem": ("gups", "8GiB-hot", "elementwise"),
         "hmsdk": ("gapbs-pr", "kron", "sparse")}
PHASES = ("first_touch", "observe", "plan", "cost")


def _study(engine):
    workload, inp, sampler = CASES[engine]
    return Study(ExperimentSpec(
        engine=engine, workload=WorkloadSpec(workload, inp, scale=0.01),
        options=SimOptions(seed=7, sampler=sampler, crn=True, device="cpu")))


def _configs(engine):
    space = get_space(engine)
    rng = np.random.default_rng(5)
    return [space.default_config()] + [space.sample(rng) for _ in range(2)]


def _profiled_run(study, configs):
    """``study.run(configs)`` under the profiler; its results and its
    ``repro_torch.*`` spans as ``(name, start_ns, end_ns)``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results = study.run(configs=configs)
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CPU
             and e.name().startswith("repro_torch.")]
    return results, sorted(spans, key=lambda s: s[1])


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(spans, outer):
    return [s for s in spans if outer[1] <= s[1] and s[2] <= outer[2]
            and s is not outer]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.total_s == y.total_s
        for field in ("epoch_wall_ms", "cum_migrations", "fast_hit_rate",
                      "sampling_ms", "stall_ms"):
            np.testing.assert_array_equal(getattr(x, field),
                                          getattr(y, field))


@pytest.mark.parametrize("engine", sorted(CASES))
def test_run_emits_the_span_tree(engine):
    study = _study(engine)
    _, spans = _profiled_run(study, _configs(engine))
    E = study.workload().n_epochs
    (run,) = _named(spans, "repro_torch.study.run")
    assert _inside(spans, run) == [s for s in spans if s is not run]
    for name in ("repro_torch.workload.build", "repro_torch.sim.trace_upload",
                 "repro_torch.sim.engine_setup"):
        assert len(_named(spans, name)) == 1, name
    assert len(_named(spans, "repro_torch.sim.results")) == 2
    epochs = _named(spans, "repro_torch.sim.epoch")
    assert len(epochs) == E
    for ep in epochs:
        inner = _inside(spans, ep)
        for phase in PHASES:
            assert len(_named(inner, f"repro_torch.sim.epoch.{phase}")) == 1
        (plan,) = _named(inner, "repro_torch.sim.epoch.plan")
        (select,) = _named(inner, "repro_torch.sim.epoch.select")
        assert _inside(inner, plan) == [select]
    # the layers follow each other: build, upload, set-up, epochs, results
    order = [s[0] for s in spans
             if s[0] != "repro_torch.study.run"
             and not s[0].startswith("repro_torch.sim.epoch")]
    assert order == ["repro_torch.workload.build",
                     "repro_torch.sim.trace_upload",
                     "repro_torch.sim.engine_setup",
                     "repro_torch.sim.results", "repro_torch.sim.results"]
    assert run[1] <= epochs[0][1] and epochs[-1][2] <= run[2]


def test_workload_build_only_on_a_studys_first_run():
    study, configs = _study("hemem"), _configs("hemem")
    _, first = _profiled_run(study, configs)
    _, second = _profiled_run(study, configs)
    assert len(_named(first, "repro_torch.workload.build")) == 1
    assert _named(second, "repro_torch.workload.build") == []
    assert len(_named(second, "repro_torch.study.run")) == 1


@pytest.mark.parametrize("engine", sorted(CASES))
def test_no_profiler_no_record_function_same_results(engine, monkeypatch):
    configs = _configs(engine)
    traced, _ = _profiled_run(_study(engine), configs)

    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    plain = _study(engine).run(configs=configs)
    _equal(plain, traced)
