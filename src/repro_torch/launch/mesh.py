"""Mesh construction over a ``torch.distributed`` world.

Defined as FUNCTIONS (never module-level state) so that importing this
module touches no process group: the dry-run initialises a fake world of
256 or 512 ranks first, a test spawns its own gloo ranks, and a training
run on the card initialises NCCL here (:func:`make_local_mesh`).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.distributed import init_world

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The pod mesh: 16x16 (256 ranks) per pod; 2 pods.  The world must
    already hold 256 or 512 ranks (the dry-run's fake process group, or a
    real cluster)."""
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = MULTI_POD_AXES if multi_pod else PRODUCTION_AXES
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A ("data", "model") mesh over the world that is initialised (a
    world of one initialises itself: NCCL on ``cuda``, gloo on ``cpu``).
    ``data`` and ``model`` are cut to what the world holds, as the
    reference's are to its devices; ``data * model`` must then be the
    world's size."""
    init_world(device_type)
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(1, n // data))
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh does not cover the "
                         f"world of {n} ranks")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=PRODUCTION_AXES)
