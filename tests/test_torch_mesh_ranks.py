"""The port's sharded train and serve steps on a spawned 4-process gloo
world on the CPU, against its own single-process path (which
``test_torch_train*.py`` and ``test_torch_lm.py`` hold against the
reference).

One world runs every case (spawning four ranks that import torch costs
seconds).  Training: on the ("data", "model") meshes (2, 2), (4, 1) and
(1, 4), two float32 steps of the chatglm3-6b, granite-moe-1b-a400m (the
MoE buffer spec set: the slots reduce-scattered over "data"),
recurrentgemma-2b and whisper-base smoke configs, each rank on its rows of
the batch, with AdamW (on (2, 2) and (1, 4) also with sequence
parallelism, ``ACTIVATION_SPEC`` ("data", "model", None): the residual
stream split over "model" along the sequence) and with Adafactor (its row
and column means and update RMS summed over the mesh): losses and grad
norms within ``RANK_TOL`` of one process, the optimizer's moments or
factors within ``MOMENT_TOL`` leaf by leaf, and every parameter whose
gradients stand above rounding within ``UPDATE_TOL_LR`` of its
single-process value.  Serving, on (2, 2) and (1, 4): the sharded prefill
step and 12 teacher-forced decode steps (a KV cache whose sequence is
split over "model" and combined by distributed flash-decode, written by
the rank that holds the slot, around a ring; RG-LRU state gathered over
"model"; whisper-base's cross K/V primed from the encoder; the
vocab-parallel logits) against the unsharded steps on each rank's rows,
within ``RANK_TOL``.  Then the elastic run: the Trainer 2 steps on (2, 2),
``restore_elastic`` onto (4, 1) for a step, a checkpoint, onto the plain
CPU device for a step; the losses those of 4 unsharded steps.  And a
plain checkpoint loaded as DTensors on (2, 2) by
``load_checkpoint(placements=...)``.  The world is bounded as the fleet
tests are (``_torch_fleet_common``).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_fleet_common import WAIT_S, bounded_test  # noqa: E402,F401
from _torch_mesh_common import (DECODE_STEPS, ELASTIC,  # noqa: E402
                                ELASTIC_ARCH, GRAD_FLOOR, LRS, MOMENT_TOL,
                                RANK_ARCHS, RANK_TOL, SERVE_ARCHS,
                                SERVE_MESHES, TRAIN_CASES, UPDATE_TOL_LR,
                                f32, max_rel, run_world, single_losses)

#: the world's own bound: it trains 32 cases, serves 6 and runs the
#: elastic run (about 25 s alone, its ranks on one thread each)
WORLD_WAIT_S = 8 * WAIT_S


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("elastic"), WORLD_WAIT_S)


@pytest.fixture(scope="module")
def single():
    return {(arch, opt): single_losses(arch, opt) for arch in RANK_ARCHS
            for opt in ("adamw", "adafactor")}


def _scaled(a, b) -> float:
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize(
    "case", TRAIN_CASES,
    ids=lambda c: f"{c[2]}-{c[0][0]}x{c[0][1]}{'-sp' if c[1] else ''}")
@pytest.mark.parametrize("arch", RANK_ARCHS)
def test_sharded_steps_equal_one_process(world, single, arch, case):
    got = world[(arch,) + case]
    want = single[(arch, case[2])]
    assert max_rel(got["losses"], want["losses"]) < RANK_TOL, \
        (got["losses"], want["losses"])
    assert max_rel(got["norms"], want["norms"]) < RANK_TOL, \
        (got["norms"], want["norms"])
    assert sorted(got["state"]) == sorted(want["state"])
    for kind, leaves in want["state"].items():
        for k, w in leaves.items():
            g = got["state"][kind][k]
            assert g.shape == w.shape, (kind, k)
            assert _scaled(g, w) < MOMENT_TOL, (kind, k, _scaled(g, w))
    assert sorted(got["params"]) == sorted(want["params"])
    kept = 0
    for k, w in want["params"].items():
        g = got["params"][k]
        assert g.shape == w.shape, k
        g1, g2 = (np.abs(s[k]) for s in want["grads"])
        mask = (g1 > GRAD_FLOOR * g1.max()) & (g2 > GRAD_FLOOR * g2.max())
        kept += int(mask.sum())
        if mask.any():
            err = float(np.abs(g - w)[mask].max()) / sum(LRS)
            assert err < UPDATE_TOL_LR, (k, err)
    assert kept > 0


@pytest.mark.parametrize("shape", SERVE_MESHES,
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", [a for a, _ in SERVE_ARCHS])
def test_sharded_serving_equals_one_process(world, arch, shape):
    err, n = world[("serve", arch, shape)]
    assert n == DECODE_STEPS + 1
    assert err < RANK_TOL, err


def test_elastic_remesh_continues(world, tmp_path):
    from repro_torch.train.trainer import Trainer
    tr = Trainer(f32(ELASTIC_ARCH), str(tmp_path / "one"), device="cpu",
                 **ELASTIC)
    try:
        want = [m["loss"] for m in tr.run(n_steps=4,
                                          log_every=1)["metrics"]]
    finally:
        tr.close()
    got = world["elastic"]
    assert len(got) == 4
    assert max_rel(got, want) < RANK_TOL, (got, want)


def test_checkpoint_loads_into_placements(world):
    local, a, b = world["placements"]
    assert local == (8, 4)
    np.testing.assert_array_equal(a, np.arange(16 * 8).reshape(16, 8))
    np.testing.assert_array_equal(b, np.ones(3))
