"""The one traffic generator: a pass's configurations from a traffic mix
(``traffic/<mix>.json``), the configuration's knob table and a seed.

Kinds of mix:

* ``"grid"``: the exhaustive product of the values listed per knob under
  ``"axes"`` (the first axis outermost), every other knob at its default;
  the same configurations in every pass.
* ``"latin"``: ``"n"`` configurations drawn over every knob of the table
  by a Latin hypercube: knob by knob, the n values sit at the centres of n
  equal strata of the unit interval, mapped onto the knob's range
  (log-uniformly where the table marks the knob ``log``) and rounded where
  it is an integer; each knob's values are shuffled by the seed.  Every
  seed thus gives the same values of each knob, paired differently, so a
  pass's sizes do not depend on the seed.

``"add_default": true`` appends the table's default configuration.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Dict, List, Mapping

import numpy as np

Config = Dict[str, Any]


def knob_value(knob: Mapping[str, Any], u: float):
    """The value at unit position ``u`` of ``knob``'s range."""
    lo, hi = float(knob["lo"]), float(knob["hi"])
    if knob["log"]:
        v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        v = lo + u * (hi - lo)
    v = min(max(v, lo), hi)
    return int(round(v)) if knob["int"] else v


def default_config(knobs) -> Config:
    return {k["name"]: (int(k["default"]) if k["int"] else
                        float(k["default"])) for k in knobs}


def check_config(knobs, config: Mapping[str, Any]) -> None:
    """Raise unless ``config`` sets every knob of the table, in range."""
    names = {k["name"] for k in knobs}
    if set(config) != names:
        raise ValueError(f"config knobs {sorted(config)} are not the "
                         f"table's {sorted(names)}")
    for k in knobs:
        v = config[k["name"]]
        if not k["lo"] <= v <= k["hi"] or (k["int"] and v != int(v)):
            raise ValueError(f"{k['name']}={v!r} is outside "
                             f"[{k['lo']}, {k['hi']}]")


def pass_configs(config: Mapping[str, Any], traffic: Mapping[str, Any],
                 seed: int) -> List[Config]:
    """The configurations of one pass of ``traffic`` with seed ``seed``."""
    knobs = config["knobs"]
    base = default_config(knobs)
    kind = traffic["kind"]
    if kind == "grid":
        axes = traffic["axes"]
        out = [dict(base, **dict(zip(axes, values)))
               for values in itertools.product(*axes.values())]
    elif kind == "latin":
        n = int(traffic["n"])
        rng = np.random.default_rng(seed % 2 ** 64)
        centres = (np.arange(n) + 0.5) / n
        cols = {k["name"]: [knob_value(k, float(u))
                            for u in rng.permutation(centres)]
                for k in knobs}
        out = [{name: cols[name][i] for name in cols} for i in range(n)]
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    if traffic.get("add_default"):
        out.append(dict(base))
    for c in out:
        check_config(knobs, c)
    return out
