"""The port's dry-run (``repro_torch.launch.dryrun``) on the fake process
group at smoke configs, on the CPU.

Each step kind (train, prefill, decode) of a dense (chatglm3-6b), a MoE
(granite-moe-1b-a400m) and an encoder-decoder (whisper-base) arch on the
single (16, 16) and the multi-pod (2, 16, 16) mesh: the JSON keys named
after the reference's, the per-rank bytes of parameters, optimizer state,
batch and cache equal to the specs' arithmetic, the peak at least what
the rank holds, collectives counted by kind.  At a (1, 1) mesh the FLOPs
equal those counted on the unsharded step.  ``long_500k`` is skipped
exactly where the reference skips it, with its reason.  The CLI writes a
file per cell.  The mesh modules import neither ``jax`` nor ``repro``.
"""

import json
import math

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import distributed as D  # noqa: E402
from repro_torch.configs import all_arch_ids, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.optim import Adafactor, AdamW  # noqa: E402

ARCHS = ("chatglm3-6b", "granite-moe-1b-a400m", "whisper-base")
KINDS = ("train_4k", "prefill_32k", "decode_32k")
MESH_SHAPES = {"single": {"data": 16, "model": 16},
               "multi": {"pod": 2, "data": 16, "model": 16}}
KEYS = {"arch", "shape", "mesh", "n_chips", "memory", "cost_analysis",
        "collective_bytes_total", "collective_bytes", "collective_count",
        "param_count", "active_param_count", "step_kind", "trace_s",
        "no_counterpart"}
#: a small train shape for the (1, 1) FLOP comparison
SMALL_TRAIN = ShapeConfig("train_small", 64, 4, "train")


@pytest.fixture(autouse=True)
def no_world():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _spec_bytes(shape, spec, mesh_shape, dtype):
    return math.prod(D.local_shape(shape, spec, mesh_shape)) * \
        torch.empty((), dtype=dtype).element_size()


def _param_bytes(cfg, mesh_shape):
    specs = T.param_specs(cfg)
    return sum(_spec_bytes(p.shape, specs[n], mesh_shape, p.dtype)
               for n, p in T.shape_init(cfg).named_parameters())


def _opt_bytes(cfg, mesh_shape, opt_name):
    specs = T.param_specs(cfg)
    params = dict(T.shape_init(cfg).named_parameters())
    if opt_name == "adamw":
        st = AdamW().state_specs(specs)
        return 2 * sum(_spec_bytes(p.shape, specs[n], mesh_shape,
                                   torch.float32) for n, p in params.items())
    st = Adafactor().state_specs(specs)
    total = 0
    for n, p in params.items():
        s = tuple(p.shape)
        vr = s[:-1] if len(s) >= 2 else s
        vc = s[:-2] + s[-1:] if len(s) >= 2 else (1,)
        total += _spec_bytes(vr, st[1][n], mesh_shape, torch.float32)
        total += _spec_bytes(vc, st[2][n], mesh_shape, torch.float32)
    return total


def _cache_bytes(cfg, B, S, mesh_shape):
    dp = mesh_shape.get("pod", 1) * mesh_shape["data"]
    like = T.decode_init(cfg, B, S, device="meta")
    total = 0
    for entry, specs in zip(like, T.cache_specs(cfg)):
        for k, leaves in entry.items():
            for t, sp in zip(leaves, specs[k]):
                if not isinstance(t, torch.Tensor):
                    continue
                if B % dp:
                    sp = tuple(None if a == "data" else a for a in sp)
                sp = tuple(("pod", "data") if a == "data" and "pod" in
                           mesh_shape else a for a in sp)
                total += _spec_bytes(t.shape, sp, mesh_shape, t.dtype)
    return total


@pytest.mark.parametrize("mesh_name", sorted(MESH_SHAPES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_json_and_bytes(arch, kind, mesh_name):
    res = dryrun.lower_cell(arch, kind, mesh_name, smoke=True)
    assert KEYS <= set(res), KEYS - set(res)
    json.dumps(res)
    cfg = get_config(arch, smoke=True)
    shape = SHAPES[kind]
    ms = MESH_SHAPES[mesh_name]
    n = math.prod(ms.values())
    assert res["n_chips"] == n
    assert set(res["collective_bytes"]) == set(dryrun.COLLECTIVES)
    mem = res["memory"]
    assert mem["param_bytes"] == _param_bytes(cfg, ms)
    dp = ms.get("pod", 1) * ms["data"]
    rows = shape.global_batch // dp if shape.global_batch % dp == 0 \
        else shape.global_batch
    extra = 0
    if cfg.family == "encdec":
        extra = rows * cfg.enc_ctx * cfg.d_model * 4
    if shape.kind == "train":
        assert res["step_kind"] == "train_step"
        assert res["optimizer"] == "adamw"
        assert mem["optimizer_bytes"] == _opt_bytes(cfg, ms, "adamw")
        assert mem["batch_bytes"] == 2 * rows * shape.seq_len * 8 + extra
        assert res["n_micro"] >= 1
    elif shape.kind == "prefill":
        assert res["step_kind"] == "prefill_step"
        assert mem["batch_bytes"] == rows * shape.seq_len * 8 + extra
    else:
        assert res["step_kind"] == "serve_step"
        assert res["kv_len"] == shape.seq_len
        assert mem["cache_bytes"] == _cache_bytes(cfg, shape.global_batch,
                                                  shape.seq_len, ms)
    held = sum(v for k, v in mem.items() if k != "peak_bytes")
    assert mem["peak_bytes"] >= mem["param_bytes"]
    assert held > 0 and res["cost_analysis"]["flops"] > 0
    assert res["collective_count"]["all-gather"] > 0


def _one_by_one():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("kind", ["train", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_at_one_by_one_equal_unsharded(arch, kind):
    cfg = get_config(arch, smoke=True)
    shape = SMALL_TRAIN if kind == "train" else SHAPES[kind]
    flat = dryrun.trace_cell(cfg, shape, None)
    sharded = dryrun.trace_cell(cfg, shape, _one_by_one())
    assert sharded["cost_analysis"]["flops"] == flat["cost_analysis"]["flops"]
    assert sharded["memory"]["param_bytes"] == flat["memory"]["param_bytes"]


def test_long_500k_skipped_where_the_reference_skips():
    pytest.importorskip("jax")
    from repro.configs import get_config as ref_config
    from repro.models.config import SHAPES as REF_SHAPES
    from repro.models.registry import shape_applicable as ref_applicable
    for arch in all_arch_ids():
        res = dryrun.lower_cell(arch, "long_500k", "single", smoke=True)
        ref_skip = not ref_applicable(ref_config(arch, smoke=True),
                                      REF_SHAPES["long_500k"])
        assert ("skipped" in res) == ref_skip, arch
        if ref_skip:
            assert res["skipped"] == (
                "long_500k needs sub-quadratic attention; "
                f"{arch} is full-attention (see DESIGN.md)")


def test_cli_writes_a_file_per_cell(tmp_path):
    rc = dryrun.main(["--smoke", "--arch", "chatglm3-6b", "--shape",
                      "decode_32k", "--out", str(tmp_path)])
    assert rc == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["chatglm3-6b__decode_32k__multi.json",
                     "chatglm3-6b__decode_32k__single.json"]


def test_mesh_modules_import_neither_jax_nor_repro():
    import os
    import subprocess
    import sys
    code = ("import sys\n"
            "import repro_torch.distributed, repro_torch.launch.mesh\n"
            "import repro_torch.launch.dryrun, repro_torch.models.sharded\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=src))
