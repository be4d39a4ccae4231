"""Whole runs of the harness on the CPU at a small scale, for the tests:
the driver is built directly on the CPU, and the few calls the harness
makes to the card are stood in for."""

import time

from tierbench import bench, load

SCALE = 0.01


def stand_in_for_the_card(setattr_=setattr):
    """Make the harness's calls to ``torch.cuda`` harmless on the CPU;
    ``setattr_`` is ``monkeypatch.setattr`` in a test."""
    import torch
    for name, fn in (("synchronize", lambda *a, **k: None),
                     ("reset_peak_memory_stats", lambda *a, **k: None),
                     ("max_memory_allocated", lambda *a, **k: 0),
                     ("get_device_name", lambda *a, **k: "cpu")):
        setattr_(torch.cuda, name, fn)


def cpu_run(cell_name, seed, trace=False, scale=SCALE, setattr_=setattr):
    """One run of ``cell_name`` with a window of a single pass."""
    t0 = time.perf_counter()
    stand_in_for_the_card(setattr_)
    cell = bench.Cell(cell_name)
    drv_mod = load("drivers", cell.config["driver"])
    driver = drv_mod.Driver(cell.config, cell.traffic, seed, "cpu", scale)
    return bench.measure(cell, drv_mod, driver, 0.0, trace, t0,
                         {"program": time.perf_counter()})
