"""The numpy reference against the program on the CPU, at small scales;
the control (the reference in bfloat16) against the limits."""

import numpy as np
import pytest
import torch

from repro_torch.core.workloads import make_workload
from repro_torch.kernels.ref import select_topk_ref

from tierbench import bench, load
from tierbench.reference import core

SCALE = 0.01
CELLS = ["gups-hemem.grid", "gapbs-pr-hmsdk.sweep"]


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 9])
def test_reference_trace_is_the_programs(cell_name, seed):
    cfg = bench.Cell(cell_name).config
    wl = make_workload(cfg["workload"], cfg["input"], threads=12,
                       scale=SCALE, seed=seed)
    ref = core.build_workload(cfg, seed, SCALE)
    assert (ref["n_pages"], ref["n_epochs"]) == (wl.n_pages, wl.n_epochs)
    for e in range(wl.n_epochs):
        for a, b in zip(wl.epoch_access(e), ref["epoch_access"](e)):
            np.testing.assert_array_equal(a, b)


def test_full_scale_sizes_are_the_configurations():
    for cell_name in CELLS:
        cfg = bench.Cell(cell_name).config
        wl = make_workload(cfg["workload"], cfg["input"], threads=12,
                           scale=cfg["scale"], seed=1)
        assert (wl.n_pages, wl.n_epochs) == (cfg["n_pages"],
                                             cfg["n_epochs"])
        assert core.fast_capacity(wl.n_pages, cfg["fast_slow_ratio"]) == \
            cfg["fast_pages"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_selection_is_the_kernels(seed):
    rng = np.random.default_rng(seed)
    B, n = 4, 300
    heat = rng.integers(0, 6, (B, n)).astype(np.float32)  # many ties
    pm, dm = rng.uniform(size=(B, n)) < 0.5, rng.uniform(size=(B, n)) < 0.5
    kp = rng.integers(0, n, B).astype(np.float32)
    kd = rng.integers(0, n, B).astype(np.float32)
    tp, td = select_topk_ref(*(torch.from_numpy(a) for a in
                               (pm, heat, dm, heat, kp, kd)))
    for b in range(B):
        np.testing.assert_array_equal(
            core.select(pm[b], heat[b], kp[b], descending=True), tp[b])
        np.testing.assert_array_equal(
            core.select(dm[b], heat[b], kd[b], descending=False), td[b])


@pytest.fixture(scope="module", params=CELLS)
def driven(request):
    """A cell's driver on the CPU after two passes at a small scale."""
    cell = bench.Cell(request.param)
    mod = load("drivers", cell.config["driver"])
    d = mod.Driver(cell.config, cell.traffic, 2 ** 31 + 77, "cpu", SCALE)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small tensors: one thread is fastest
    try:
        d.warm()
        d.run_pass()
        d.run_pass()
    finally:
        torch.set_num_threads(threads)
    return cell, d


def test_program_agrees_with_the_reference(driven):
    cell, d = driven
    rows = d.compare()
    assert len(rows) >= 12
    for name, lim in cell.limits["numbers"].items():
        assert max(r[name] for r in rows) <= lim["limit"], name


def test_control_fails_the_limits(driven):
    cell, d = driven
    rows = d.control()
    assert any(max(r[name] for r in rows) > lim["limit"]
               for name, lim in cell.limits["numbers"].items())
