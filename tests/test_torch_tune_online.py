"""The port's drifting workloads and online re-tuner against the JAX
reference, on the CPU.

* ``DriftSpec``: construction-time validation, the JSON round trip and
  the content-addressed names equal the reference's; every builtin
  ``drift-*`` trace equals the reference's bitwise; segments split at a
  phase switch equal the whole run bitwise; the window histograms'
  divergence detects the phases (the reference's values, bitwise).
* ``SMACOptimizer(seed_configs=)``: the queued elites are asked first, in
  order, as the reference asks them.
* ``Study.tune(online=True)``: the smoke scenario (a 2-phase hot-set
  rotation, 16 epochs, gups at scale 0.03) re-adapts with zero thrash;
  the hysteresis margin and the budget cap hold; the journal is
  deterministic and a torn journal resumes byte-identically; against the
  reference's online run (``backend="jax", crn=True``) the detection
  windows are equal, neither thrashes, and the deployed walls agree
  within 1e-3 (the sampled-engine bar of ``tests/test_torch_engine.py``).
"""

import json

import numpy as np
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import drift as jdrift  # noqa: E402
from repro.core import specs as jax_specs  # noqa: E402
from repro.core.bo.smac import SMACOptimizer as JaxSMAC  # noqa: E402
from repro.core.study import Study as JaxStudy  # noqa: E402
from repro_torch.core import (DriftPhase, DriftSpec,  # noqa: E402
                              ExperimentSpec, SimOptions, Study)
from repro_torch.core import drift  # noqa: E402
from repro_torch.core.bo.smac import SMACOptimizer  # noqa: E402
from repro_torch.core.knobs import get_space  # noqa: E402
from repro_torch.core.registry import WORKLOADS  # noqa: E402
from repro_torch.core.simulator import run_simulation_segment  # noqa: E402
from repro_torch.core.tune_online import OnlineTuningResult  # noqa: E402
from repro_torch.core.workloads import make_workload  # noqa: E402

#: two phases of gups's hot set, 8 epochs each: two windows per phase at
#: W = 4 (the reference's own smoke scenario)
TINY = DriftSpec.hotspot(base="gups", n_phases=2, phase_epochs=8)
SCALE = 0.03
TOTAL_RTOL = 1e-3


def _study(seed=0, **opts):
    return Study(ExperimentSpec(
        engine="hemem", workload=dict(name=TINY.register(), scale=SCALE),
        options=SimOptions(seed=seed, crn=True, sampler="sparse",
                           device="cpu", **opts)))


def _tune(study, **kw):
    args = dict(online=True, window_epochs=4, batch_size=3, budget=12,
                seed=1)
    args.update(kw)
    return study.tune(**args)


# ---------------------------------------------------------------------------
# DriftSpec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("build,match", [
    (lambda m: m.DriftSpec(phases=(m.DriftPhase("gups"),), switch_epochs=(),
                           n_epochs=40), "at least 2 phases"),
    (lambda m: m.DriftSpec(phases=(m.DriftPhase("gups"),
                                   m.DriftPhase("btree")),
                           switch_epochs=(10, 20), n_epochs=40),
     "one switch epoch per phase"),
    (lambda m: m.DriftSpec(phases=(m.DriftPhase("gups"),
                                   m.DriftPhase("btree")),
                           switch_epochs=(40,), n_epochs=40),
     "strictly increasing inside"),
    (lambda m: m.DriftSpec(phases=tuple(m.DriftPhase("gups")
                                        for _ in range(3)),
                           switch_epochs=(20, 10), n_epochs=40),
     "strictly increasing"),
    (lambda m: m.DriftSpec(phases=(m.DriftPhase("gups"),
                                   m.DriftPhase("btree")),
                           switch_epochs=(5,), n_epochs=0), "n_epochs"),
    (lambda m: m.DriftPhase("gups", seed_offset=-1), "seed_offset"),
    (lambda m: m.DriftSpec.hotspot(n_phases=1), "n_phases >= 2"),
    (lambda m: m.DriftSpec.wset(fractions=(0.5,)), "at least 2"),
])
def test_drift_spec_validation_as_the_reference(build, match):
    for mod in (drift, jdrift):
        with pytest.raises(ValueError, match=match):
            build(mod)


def test_drift_spec_unknown_keys_did_you_mean():
    d = DriftSpec.hotspot().to_dict()
    d["switch_epoch"] = d.pop("switch_epochs")
    with pytest.raises(KeyError, match="did you mean 'switch_epochs'"):
        DriftSpec.from_dict(d)
    with pytest.raises(KeyError, match="did you mean 'seed_offset'"):
        DriftPhase.from_dict({"workload": {"name": "gups"},
                              "seed_offst": 1})


def test_drift_spec_round_trip_and_names_equal_the_reference():
    pairs = [
        (DriftSpec.splice("gups", "silo:ycsb-c", switch_epoch=30,
                          n_epochs=60),
         jdrift.DriftSpec.splice("gups", "silo:ycsb-c", switch_epoch=30,
                                 n_epochs=60)),
        (DriftSpec.hotspot(n_phases=2, phase_epochs=10),
         jdrift.DriftSpec.hotspot(n_phases=2, phase_epochs=10)),
        (DriftSpec.wset(fractions=(0.25, 1.0), phase_epochs=7),
         jdrift.DriftSpec.wset(fractions=(0.25, 1.0), phase_epochs=7)),
    ]
    for ours, ref in pairs:
        assert ours.to_dict() == ref.to_dict()
        assert ours.name == ref.name and ours.name.startswith("drift-")
        twin = DriftSpec.from_dict(json.loads(json.dumps(ours.to_dict())))
        assert twin == ours and twin.name == ours.name
    assert DriftSpec.hotspot(n_phases=2, phase_epochs=12).name != \
        pairs[1][0].name
    assert sorted(drift.BUILTIN_DRIFTS) == sorted(jdrift.BUILTIN_DRIFTS)
    for name, spec in drift.BUILTIN_DRIFTS.items():
        assert spec.to_dict() == jdrift.BUILTIN_DRIFTS[name].to_dict()
        assert name in WORKLOADS
    assert drift.BUILTIN_DRIFTS["drift-hotspot"].phase_starts == (0, 20, 40)
    assert DriftPhase.coerce("silo:ycsb-c").workload.input_name == "ycsb-c"


def test_drift_spec_coerces_through_experiment_spec_and_pickles():
    import pickle
    spec = DriftSpec.hotspot(n_phases=2, phase_epochs=5)
    exp = ExperimentSpec(engine="static", workload=spec,
                         options=SimOptions(device="cpu"))
    assert exp.workload.name == spec.name and spec.name in WORKLOADS
    factory = WORKLOADS.get(spec.name)
    wl = pickle.loads(pickle.dumps(factory))("", 4, SCALE, 1)
    assert wl.n_epochs == 10 and wl.name == spec.name


@pytest.mark.parametrize("name", ["drift-hotspot", "drift-wset",
                                  "drift-splice"])
def test_builtin_drift_traces_equal_the_reference_bitwise(name):
    from repro.core.workloads import make_workload as jax_make_workload
    ours = make_workload(name, "", threads=4, scale=SCALE, seed=3)
    ref = jax_make_workload(name, "", threads=4, scale=SCALE, seed=3)
    assert (ours.n_pages, ours.n_epochs, ours.epoch_ms, ours.mlp,
            ours.compute_ms, ours.rss_gib) == \
        (ref.n_pages, ref.n_epochs, ref.epoch_ms, ref.mlp, ref.compute_ms,
         ref.rss_gib)
    for e in range(ours.n_epochs):
        for a, b in zip(ours.epoch_access(e), ref.epoch_access(e)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_segments_split_at_a_phase_switch_bitwise():
    wl = make_workload("drift-splice", "", threads=8, scale=SCALE, seed=3)
    space = get_space("hemem")
    cfgs = [space.default_config(),
            space.sample(np.random.default_rng(5))]
    kw = dict(seeds=0, crn=True, device="cpu")
    whole = run_simulation_segment(wl, "hemem", cfgs, **kw)
    first = run_simulation_segment(wl, "hemem", cfgs, epoch_stop=30,
                                   return_carry=True, **kw)
    second = run_simulation_segment(wl, "hemem", cfgs, epoch_start=30,
                                    carry=first["carry"], **kw)
    stitched = np.concatenate([first["wall_ms"], second["wall_ms"]])
    assert np.array_equal(stitched, whole["wall_ms"])


def test_histogram_divergence_detects_phases_as_the_reference():
    spec = drift.BUILTIN_DRIFTS["drift-hotspot"]
    ours = drift.build_drift_workload(spec, threads=4, scale=SCALE, seed=3)
    ref = jdrift.build_drift_workload(jdrift.BUILTIN_DRIFTS["drift-hotspot"],
                                      threads=4, scale=SCALE, seed=3)
    windows = [(0, 10), (10, 20), (20, 30)]
    h = [drift.window_histogram(ours, lo, hi) for lo, hi in windows]
    hr = [jdrift.window_histogram(ref, lo, hi) for lo, hi in windows]
    for a, b in zip(h, hr):
        assert np.array_equal(a, b)
    assert drift.histogram_divergence(h[0], h[1]) == 0.0   # same phase
    assert drift.histogram_divergence(h[1], h[2]) > 0.25   # next phase
    assert drift.histogram_divergence(h[1], h[2]) == \
        jdrift.histogram_divergence(hr[1], hr[2])


# ---------------------------------------------------------------------------
# SMACOptimizer(seed_configs=)
# ---------------------------------------------------------------------------
def test_seed_configs_are_asked_first_in_order_as_the_reference():
    space = get_space("hemem")
    rng = np.random.default_rng(0)
    elites = [space.sample(rng) for _ in range(3)]
    ours = SMACOptimizer(space, seed=0, seed_configs=elites, device="cpu")
    ref = JaxSMAC(space, seed=0, seed_configs=elites)
    assert [ours.ask() for _ in range(4)] == [ref.ask() for _ in range(4)]
    ours = SMACOptimizer(space, seed=0, seed_configs=elites[:2],
                         device="cpu")
    batch = ours.ask_batch(5)
    assert batch[:2] == elites[:2] and len(batch) == 5
    assert batch == JaxSMAC(space, seed=0,
                            seed_configs=elites[:2]).ask_batch(5)
    # more seeds than the batch: the remainder stays queued
    ours = SMACOptimizer(space, seed=0, seed_configs=elites * 3,
                         device="cpu")
    assert ours.ask_batch(4) == (elites * 3)[:4]
    assert ours.ask() == elites[1]


# ---------------------------------------------------------------------------
# Study.tune(online=True)
# ---------------------------------------------------------------------------
def test_online_smoke_readapts_without_thrash():
    res = _tune(_study())
    assert isinstance(res, OnlineTuningResult)
    assert len(res.windows) == 4               # 16 epochs / W = 4
    assert res.evals_used <= 12
    assert res.thrash_events == 0
    assert res.detections >= 1                 # the rotation is detected
    assert res.windows[2].detect               # within a window of epoch 8
    w = res.windows[1]
    assert (w.epoch_lo, w.epoch_hi) == (4, 8) and w.divergence == 0.0
    assert len(w.candidate_walls_ms) == len(w.candidates)
    assert res.total_wall_ms == pytest.approx(float(res.deployed_walls.sum()))


def test_online_hysteresis_margin_and_budget_cap():
    res = _tune(_study(), hysteresis=0.999)
    assert res.switches == 0 and res.thrash_events == 0
    res = _tune(_study(), budget=5)
    assert res.evals_used <= 5
    assert all(len(w.candidates) == 0 for w in res.windows[2:])


def test_online_journal_deterministic_and_resumable(tmp_path):
    j1, j2, jt = (tmp_path / n for n in ("a.jsonl", "b.jsonl",
                                         "torn.jsonl"))
    _tune(_study(), journal=str(j1))
    _tune(_study(), journal=str(j2))
    ref = j1.read_bytes()
    assert j2.read_bytes() == ref
    lines = ref.splitlines(keepends=True)
    assert len(lines) >= 5
    jt.write_bytes(b"".join(lines[:3]) + lines[3][:len(lines[3]) // 2])
    res = _tune(_study(), journal=str(jt), resume=True)
    assert jt.read_bytes() == ref
    assert res.thrash_events == 0
    with pytest.raises(ValueError, match="diverged"):
        _tune(_study(), journal=str(j1), resume=True, seed=2)


def test_online_refusals():
    with pytest.raises(ValueError, match="window_epochs"):
        _study().tune(online=True)
    with pytest.raises(ValueError, match="online=True"):
        _study().tune(window_epochs=4)
    with pytest.raises(ValueError, match="incompatible"):
        _tune(_study(), executor="async")
    st = Study(ExperimentSpec(
        engine="hemem", workload=dict(name=TINY.register(), scale=SCALE),
        options=SimOptions(device="cpu")))
    with pytest.raises(ValueError, match="crn=True"):
        _tune(st)


def test_online_against_the_reference():
    ours = _tune(_study())
    jspec = jax_specs.ExperimentSpec(
        engine="hemem",
        workload=dict(name=jdrift.DriftSpec.hotspot(
            base="gups", n_phases=2, phase_epochs=8).register(),
            scale=SCALE),
        options=jax_specs.SimOptions(seed=0, backend="jax", crn=True,
                                     sampler="sparse"))
    ref = _tune(JaxStudy(jspec))
    assert [w.detect for w in ours.windows] == [w.detect for w in ref.windows]
    assert ours.thrash_events == ref.thrash_events == 0
    assert [w.candidates for w in ours.windows[:2]] == \
        [w.candidates for w in ref.windows[:2]]
    assert abs(ours.windows[-1].deployed_wall_ms
               - ref.windows[-1].deployed_wall_ms) \
        <= TOTAL_RTOL * ref.windows[-1].deployed_wall_ms
    assert abs(ours.total_wall_ms - ref.total_wall_ms) \
        <= TOTAL_RTOL * ref.total_wall_ms
