"""The port's sharding specs, mesh helpers and EF-int8 all-reduce against
the reference's (``repro.distributed``, ``repro.models``,
``repro.optim``), on the CPU.

* ``transformer.param_specs`` equals the reference's ``T.shape_init``
  specs leaf by leaf for all 10 registry archs at full width (the port's
  leaves are per layer: the reference's stacked spec without its leading
  ``None``), and every reference leaf is covered;
* AdamW's and Adafactor's ``state_specs`` likewise; where the reference
  factors a stacked 1-D leaf (a norm vector) over the stack, which the
  port's per-layer vector is not, the leaf is named and skipped;
* the per-rank parameter bytes of the port's DTensor placements on a fake
  (16, 16) and (2, 16, 16) world equal the arithmetic of the reference's
  specs;
* ``compressed_psum`` on 4 gloo ranks against the reference's under
  ``jax.vmap(..., axis_name="pod")``: payload and scale bitwise, result and
  residual within 1e-6;
* ``dp_size``, ``tp_size``, ``dp_axes``, ``batch_spec`` and
  ``validate_divisibility`` against the reference's on the same mesh
  shapes, and ``placements`` of every spec form.
"""

import math
import types

import numpy as np
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from _torch_fleet_common import WAIT_S, bounded_test  # noqa: E402,F401
from _torch_mesh_common import free_port, ref_leaf, ref_paths  # noqa: E402
from repro_torch import distributed as D  # noqa: E402
from repro_torch.configs import all_arch_ids, get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import Adafactor, AdamW  # noqa: E402

ARCHS = all_arch_ids()
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(scope="module")
def ref_specs():
    from repro.configs import get_config as ref_config
    from repro.models import transformer as RT
    out = {}
    for arch in ARCHS:
        shapes, specs = RT.shape_init(jax.random.PRNGKey(0),
                                      ref_config(arch))
        out[arch] = (shapes, specs)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(ref_specs, arch):
    _, specs = ref_specs[arch]
    cfg = get_config(arch)
    port = T.param_specs(cfg)
    names = [n for n, _ in T.shape_init(cfg).named_parameters()]
    assert sorted(port) == sorted(names)
    seen = set()
    for name, spec in port.items():
        want, path, _ = ref_leaf(specs, name)
        assert spec == want, (name, spec, want)
        seen.add(path)
    assert seen == ref_paths(specs)


def _state_leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tuple(tree)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_equal_reference(ref_specs, arch, opt):
    from repro.optim import make_optimizer as ref_opt
    shapes, specs = ref_specs[arch]
    cfg = get_config(arch)
    port_specs = T.param_specs(cfg)
    port = (AdamW() if opt == "adamw" else Adafactor()).state_specs(
        port_specs)
    ref = ref_opt(opt).state_specs(specs)
    assert tuple(port[0]) == tuple(ref[0]) == ()
    params = dict(T.shape_init(cfg).named_parameters())
    skipped = []
    for field in (1, 2):
        for name in port_specs:
            _, path, stacked = ref_leaf(specs, name)
            want = _state_leaf(ref[field], path)
            got = port[field][name]
            if stacked and params[name].ndim < 2 and opt == "adafactor":
                # the reference's stacked vector is 2-D: it factors it
                # over the stack (ROADMAP queue 3 b); the port does not
                skipped.append(name)
                continue
            if stacked:
                assert want[0] is None, (name, want)
                want = want[1:]
            assert tuple(got) == want, (field, name, got, want)
    assert all(params[n].ndim < 2 for n in skipped)


def _ref_bytes(shapes, specs, mesh_shape):
    from jax.sharding import PartitionSpec as P
    leaves = jax.tree.leaves(shapes)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for s, sp in zip(leaves, spec_leaves):
        local = D.local_shape(s.shape, tuple(sp), mesh_shape)
        total += math.prod(local) * np.dtype(s.dtype).itemsize
    return total


@pytest.fixture
def fake_world():
    from repro_torch.launch import dryrun
    yield dryrun.make_mesh
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_per_rank_param_bytes_equal_spec_arithmetic(ref_specs, fake_world,
                                                    arch, mesh_name):
    shapes, specs = ref_specs[arch]
    mesh = fake_world(mesh_name)
    model = D.abstract_params(get_config(arch), mesh)
    got = sum(D.local_bytes(p) for p in model.parameters())
    assert got == _ref_bytes(shapes, specs, MESHES[mesh_name])


def test_mesh_helpers_equal_reference(fake_world):
    from repro import distributed as RD
    from repro.models.config import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro_torch.models.config import SHAPES
    for mesh_name, shape in MESHES.items():
        mesh = fake_world(mesh_name)
        ref = types.SimpleNamespace(axis_names=tuple(shape), shape=shape)
        assert D.dp_size(mesh) == RD.dp_size(ref)
        assert D.tp_size(mesh) == RD.tp_size(ref)
        assert D.dp_axes(mesh) == RD.dp_axes(ref)
        assert D.batch_spec(mesh, 2) == tuple(RD.batch_spec(ref, 2))
        for arch in ("chatglm3-6b", "kimi-k2-1t-a32b"):
            for name in SHAPES:
                assert D.validate_divisibility(
                    get_config(arch), SHAPES[name], mesh) == \
                    RD.validate_divisibility(ref_config(arch),
                                             REF_SHAPES[name], ref)


def test_placements_of_spec_forms(fake_world):
    from torch.distributed.tensor import Replicate, Shard
    mesh = fake_world("multi")
    assert D.placements((("pod", "data"), None), mesh) == (
        Shard(0), Shard(0), Replicate())
    assert D.placements(("model", "data"), mesh) == (
        Replicate(), Shard(1), Shard(0))
    assert D.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        D.placements(("data", "data"), mesh)


# ---------------------------------------------------------------------------
# compressed_psum over 4 ranks
# ---------------------------------------------------------------------------
PSUM_RANKS = 4
PSUM_SHAPE = (33, 17)


def _psum_inputs():
    rng = np.random.default_rng(7)
    g = rng.normal(size=(PSUM_RANKS,) + PSUM_SHAPE).astype(np.float32)
    r = (rng.normal(size=(PSUM_RANKS,) + PSUM_SHAPE) * 1e-3).astype(
        np.float32)
    g[2] *= 40.0   # one rank's scale dominates the max
    return g, r


def _psum_rank(rank, port, out):
    import traceback
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=PSUM_RANKS)
        from repro_torch.optim import compressed_psum, ef_compress
        g, r = _psum_inputs()
        gt, rt = torch.from_numpy(g[rank]), torch.from_numpy(r[rank])
        q, scale, _ = ef_compress(gt, rt)
        mean, res = compressed_psum(gt, rt, dist.group.WORLD)
        out.put((rank, q.numpy(), scale.numpy(), mean.numpy(), res.numpy()))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, traceback.format_exc(), None, None, None))


def test_compressed_psum_equals_reference():
    import multiprocessing as mp
    from repro.optim import compressed_psum as ref_psum
    from repro.optim import ef_compress as ref_compress
    g, r = _psum_inputs()
    ref_mean, ref_res = jax.vmap(lambda a, b: ref_psum(a, b, "pod"),
                                 axis_name="pod")(g, r)
    ref_q, ref_scale, _ = jax.vmap(ref_compress)(g, r)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_psum_rank, args=(k, port, out), daemon=True)
             for k in range(PSUM_RANKS)]
    for p in procs:
        p.start()
    try:
        got = sorted((out.get(timeout=WAIT_S) for _ in procs),
                     key=lambda t: t[0])
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    for rank, q, scale, mean, res in got:
        assert isinstance(q, np.ndarray), q
        np.testing.assert_array_equal(q, np.asarray(ref_q[rank]))
        assert scale.tobytes() == np.asarray(ref_scale[rank]).tobytes()
        np.testing.assert_allclose(mean, np.asarray(ref_mean[rank]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(res, np.asarray(ref_res[rank]),
                                   rtol=1e-6, atol=1e-6)
