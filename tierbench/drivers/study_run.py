"""Driver of the simulator cells: batched ``Study.run(configs=...)`` passes
of ``repro_torch`` on the card, judged against the numpy reference.

A pass is what a user of the tuner pays for: one configuration-batch of
the cell's traffic simulated over the whole trace.  Each pass of a run
takes its own simulation seed, :func:`pass_seed` of the run's seed and
its index (the build seed of the trace and the key of the monitoring
draws), and that seed's configurations.
"""

from __future__ import annotations

import gc
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from ..generate import pass_configs
from ..reference import core as reference

#: the end-to-end rate a pass's work counts towards
RATE_METRIC = "sim_configs_per_s"
#: passes the reference judges, and configurations judged in each
JUDGED_PASSES = 3
JUDGED_ROWS = 8


def pass_seed(seed: int, i: int) -> int:
    """The simulation seed of pass ``i`` of a run (``-1``: the warm-up
    pass): a hash of both, so runs with near seeds share no pass."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, i + 1])
               .generate_state(1)[0])


class Driver:
    """The system under test for one cell: ``Study`` objects of the
    configuration, one per pass seed, on ``device``."""

    def __init__(self, config: Mapping[str, Any], traffic: Mapping[str, Any],
                 seed: int, device: str, scale: Optional[float] = None):
        from repro_torch.core import (EngineSpec, ExperimentSpec, SimOptions,
                                      Study, WorkloadSpec)
        self._types = (EngineSpec, ExperimentSpec, SimOptions, Study,
                       WorkloadSpec)
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = device
        self.scale = float(config["scale"] if scale is None else scale)
        self.passes: List[Dict[str, Any]] = []

    def _study(self, sim_seed: int):
        EngineSpec, ExperimentSpec, SimOptions, Study, WorkloadSpec = \
            self._types
        c = self.config
        return Study(ExperimentSpec(
            engine=EngineSpec(c["engine"]),
            workload=WorkloadSpec(c["workload"], c["input"],
                                  threads=int(c["threads"]),
                                  scale=self.scale),
            machine=c["machine"], fast_slow_ratio=float(c["fast_slow_ratio"]),
            options=SimOptions(seed=sim_seed, sampler=c["sampler"],
                               crn=bool(c["crn"]), device=self.device)))

    def _run(self, sim_seed: int):
        configs = pass_configs(self.config, self.traffic, sim_seed)
        study = self._study(sim_seed)
        return configs, study, study.run(configs=configs)

    def warm(self) -> None:
        """One pass at the cell's shapes (builds or loads ``select_topk``,
        fills the allocator); checks that the program runs the sizes the
        configuration file states."""
        configs, study, _ = self._run(pass_seed(self.seed, -1))
        wl = study.workload()
        if self.scale == float(self.config["scale"]):
            stated = (self.config["n_pages"], self.config["n_epochs"])
            if (wl.n_pages, wl.n_epochs) != tuple(stated):
                raise RuntimeError(
                    f"the program runs {wl.n_pages} pages x {wl.n_epochs} "
                    f"epochs; the configuration states {stated}")
        self.n_pages, self.n_epochs = wl.n_pages, wl.n_epochs

    def run_pass(self) -> int:
        """One whole pass; returns the configurations it simulated."""
        sim_seed = pass_seed(self.seed, len(self.passes))
        configs, _, results = self._run(sim_seed)
        self.passes.append({
            "seed": sim_seed, "configs": configs,
            "total_s": np.array([r.total_s for r in results]),
            "cum_migrations": np.stack([r.cum_migrations for r in results]),
            "fast_hit_rate": np.stack([r.fast_hit_rate for r in results])})
        return len(configs)

    def shapes(self) -> Dict[str, Any]:
        """What the trace readers need of the profiled passes: epochs, and
        the (rows, pages) of each ``select_topk`` launch."""
        return {"epochs": self.n_epochs * len(self.passes),
                "select_topk": [(len(p["configs"]), self.n_pages)
                                for p in self.passes]}

    def free(self) -> None:
        gc.collect()
        if self.device.startswith("cuda"):
            import torch
            torch.cuda.empty_cache()

    # -- correctness -------------------------------------------------------
    def judged(self) -> List[Dict[str, Any]]:
        """The (pass, rows) the reference judges, drawn from the run's
        seed: in each drawn pass the program's fastest configuration, the
        slowest, and random others."""
        rng = np.random.default_rng([self.seed % 2 ** 63, 0x7E57])
        n = len(self.passes)
        picks = sorted(rng.choice(n, size=min(JUDGED_PASSES, n),
                                  replace=False))
        out = []
        for i in picks:
            p = self.passes[i]
            B = len(p["configs"])
            ends = {int(np.argmin(p["total_s"])), int(np.argmax(p["total_s"]))}
            others = [int(b) for b in rng.permutation(B) if b not in ends]
            rows = sorted(ends | set(others[:JUDGED_ROWS - len(ends)]))
            out.append({"pass": int(i), "rows": rows})
        return out

    def _gaps(self, answers) -> List[Dict[str, float]]:
        """Per judged configuration, its gaps to the float32 reference:
        relative in total time, in migrated pages over the reference's
        count, absolute in hit rate.  ``answers(p, rows)`` gives, for
        pass ``p``'s judged rows, ``(total_s, cum_migrations,
        fast_hit_rate)`` each."""
        out = []
        for j in self.judged():
            p = self.passes[j["pass"]]
            refs = reference.simulate(
                self.config, [p["configs"][b] for b in j["rows"]], p["seed"],
                scale=self.scale)
            for (tot, mig, hit), r in zip(answers(p, j["rows"]), refs):
                out.append({
                    "total_s_rel": float(abs(tot - r["total_s"])
                                         / r["total_s"]),
                    "migrations_rel": float(
                        np.abs(mig - r["cum_migrations"]).max())
                    / max(float(r["cum_migrations"][-1]), 1.0),
                    "hit_rate_abs": float(
                        np.abs(hit - r["fast_hit_rate"]).max())})
        return out

    def compare(self) -> List[Dict[str, float]]:
        """The program's judged results against the reference."""
        return self._gaps(lambda p, rows: [
            (p["total_s"][b], p["cum_migrations"][b], p["fast_hit_rate"][b])
            for b in rows])

    def control(self) -> List[Dict[str, float]]:
        """The control: the reference in bfloat16, in the program's place
        on the same judged rows."""
        def answers(p, rows):
            return [(r["total_s"], r["cum_migrations"], r["fast_hit_rate"])
                    for r in reference.simulate(
                        self.config, [p["configs"][b] for b in rows],
                        p["seed"], scale=self.scale, precision="bfloat16")]
        return self._gaps(answers)
