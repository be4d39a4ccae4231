"""Knob-importance scores from the RF surrogate (§3.1, as in [5, 21]).

For each knob k: fix every other knob at its default, sweep k over its range
(via surrogate predictions), and score k by the spread of predicted execution
time.  This is the paper's "which tiering system knob(s) are more important"
analysis used to explain the Table-5 findings (e.g. that the *hidden*
``cooling_pages`` knob dominates Silo).  A copy of the reference package's
module; it runs in numpy on the host, as the reference's does.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np

from ..knobs import KnobSpace
from .rf import RandomForest
from .smac import Observation


def knob_importance(space: KnobSpace, observations: List[Observation],
                    n_sweep: int = 32, seed: int = 0,
                    base: Optional[Mapping[str, float]] = None,
                    ) -> Dict[str, float]:
    """All per-knob sweeps are stacked into ONE ``(n_knobs * n_sweep, d)``
    matrix and scored by a single flat-forest descent pass
    (``predict_batch``).  Returns each knob's share of the summed spreads,
    largest first."""
    X = np.stack([space.encode(o.config) for o in observations])
    y = np.array([o.value for o in observations])
    model = RandomForest(seed=seed).fit(X, y)

    base_cfg = space.validate(dict(base)) if base else space.default_config()
    x0 = space.encode(base_cfg)

    k = len(space)
    sweeps = np.tile(x0, (k * n_sweep, 1))
    grid = np.linspace(0.0, 1.0, n_sweep)
    for i in range(k):
        sweeps[i * n_sweep:(i + 1) * n_sweep, i] = grid
    mean, _ = model.predict_batch(sweeps)
    mean = mean.reshape(k, n_sweep)
    raw = {knob.name: float(mean[i].max() - mean[i].min())
           for i, knob in enumerate(space)}
    total = sum(raw.values()) or 1.0
    return {k: v / total for k, v in sorted(raw.items(),
                                            key=lambda kv: -kv[1])}
