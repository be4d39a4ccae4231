"""The traffic generator and the benchmark's files, on the CPU."""

import json
import re
from pathlib import Path

import pytest

from tierbench import bench
from tierbench.drivers.study_run import pass_seed
from tierbench.generate import check_config, default_config, pass_configs

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _cell(name):
    return bench.Cell(name)


def test_grid_is_fig1s_search_at_table_resolution():
    """Fig. 1's two knobs over Table 2's ranges, every integer
    read_hot_threshold and cooling_threshold in steps of 4 (a finer step
    than Fig. 1's), the other knobs at default, and the default."""
    cell = _cell("gups-hemem.grid")
    cfgs = pass_configs(cell.config, cell.traffic, 5)
    assert len(cfgs) == 301
    assert len({tuple(sorted(c.items())) for c in cfgs}) == 301
    base = default_config(cell.config["knobs"])
    assert cfgs[-1] == base
    grid = {(c["read_hot_threshold"], c["cooling_threshold"])
            for c in cfgs[:-1]}
    assert grid == {(r, c) for r in range(1, 31) for c in range(4, 41, 4)}
    # Fig. 1's read_hot_threshold values all lie on the grid
    assert {1, 2, 4, 6, 8, 12, 16, 20, 26, 30} <= {r for r, _ in grid}
    fixed = ("read_hot_threshold", "cooling_threshold")
    for c in cfgs:
        check_config(cell.config["knobs"], c)
        assert {k: v for k, v in c.items() if k not in fixed} == \
            {k: v for k, v in base.items() if k not in fixed}
    assert pass_configs(cell.config, cell.traffic, 6) == cfgs


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 40 + 3])
def test_sweep_deterministic_and_inside_the_table(seed):
    cell = _cell("gapbs-pr-hmsdk.sweep")
    a = pass_configs(cell.config, cell.traffic, seed)
    assert a == pass_configs(cell.config, cell.traffic, seed)
    assert len(a) == 257 and a[-1] == default_config(cell.config["knobs"])
    for c in a:
        check_config(cell.config["knobs"], c)
    # a Latin hypercube: each knob takes the same values under every seed
    b = pass_configs(cell.config, cell.traffic, seed + 1)
    assert a != b
    for k in cell.config["knobs"]:
        assert sorted(c[k["name"]] for c in a[:-1]) == \
            sorted(c[k["name"]] for c in b[:-1])


def test_sweep_spans_the_log_range():
    cell = _cell("gapbs-pr-hmsdk.sweep")
    a = pass_configs(cell.config, cell.traffic, 1)[:-1]
    nr = sorted(c["nr_regions"] for c in a)
    assert nr[0] <= 11 and nr[-1] >= 900
    # log-uniform: the median sits near the geometric middle of [10, 1000]
    assert 80 <= nr[len(nr) // 2] <= 125


def test_pass_seeds_are_deterministic_and_distinct():
    s = [pass_seed(2 ** 33 + 1, i) for i in range(-1, 50)]
    assert s == [pass_seed(2 ** 33 + 1, i) for i in range(-1, 50)]
    assert len(set(s)) == len(s)
    assert all(0 <= x < 2 ** 32 for x in s)
    # runs with near seeds share no pass
    assert not set(s) & {pass_seed(2 ** 33 + 2, i) for i in range(-1, 50)}


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/")
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    cells = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in cells
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        cells.add(w["name"])
        cell = bench.Cell(w["name"], BENCH)
        assert set(cell.limits["numbers"]) == {
            "total_s_rel", "migrations_rel", "hit_rate_abs"}
        assert cell.metrics("per_layer")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        assert (ROOT / "tierbench" / "metrics" / f"{m['name']}.py").is_file()
    assert len(json.dumps(BENCH)) < 64 * 1024
