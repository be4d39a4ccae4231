"""Atomic, async checkpoints, with the reference package's layout.

Layout:
  <dir>/step_00000100/
      manifest.json          -- leaf names, dtypes, aux (the data state)
      shard_00000.npz        -- the leaves, flat, as ``leaf_<i>``
  <dir>/LATEST               -- atomically renamed pointer file

Guarantees (as ``repro.ckpt.checkpoint``'s):
  * atomicity: a save writes ``step_X.tmp-<nonce>/`` and puts it in place
    with ``os.replace``; ``LATEST`` flips last, so a crash mid-save never
    corrupts the previous checkpoint, and a leftover ``.tmp-*`` directory
    is never read;
  * async: :meth:`CheckpointManager.save_async` copies the leaves to the
    host, then writes on a thread; one save is in flight at a time;
  * bf16 is stored as float32 (npz cannot hold it), its dtype recorded, so
    the round trip is exact;
  * restore onto another device: :func:`load_checkpoint` puts every leaf on
    the device it is asked for;
  * meshes: a DTensor leaf is saved as its full logical array (every rank
    joins its ``full_tensor()``, rank 0 writes), so a checkpoint written at
    any mesh loads at any other mesh or on a plain device, and the
    reverse: a leaf is laid out as the tree it is loaded into is, or as
    ``placements`` says.

A tree is a ``NamedTuple`` (fields in order), a mapping (in insertion
order), an ``nn.Module`` (its named parameters), a tensor, or an int or
float; a train state flattens to the model's parameters, then the
optimizer state, then the step.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch import distributed as D


def _writes() -> bool:
    """Rank 0 writes; every rank gathers."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Every rank waits for rank 0's write."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in the tree's fixed order."""
    if isinstance(tree, nn.Module):
        return [(f"{prefix}{k}", p) for k, p in tree.named_parameters()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pair for f in tree._fields
                for pair in _flatten(getattr(tree, f), f"{prefix}{f}/")]
    if isinstance(tree, Mapping):
        return [pair for k, v in tree.items()
                for pair in _flatten(v, f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def _shard(full: torch.Tensor, like):
    """``full`` laid out as DTensor ``like`` (each rank keeps its part)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full.to(D.local(like).device), like.device_mesh,
                             like.placements, src_data_rank=None)


def _unflatten(like, leaves: List[Any], device):
    """The tree of ``like`` with the next leaves of ``leaves`` (consumed
    from the front).  A module's parameters are written in place, after the
    module is moved to ``device`` (a distributed module stays where its
    shards are); every other tensor is new, a DTensor laid out as its
    ``like``."""
    if isinstance(like, nn.Module):
        if D.ctx_of(like) is None:
            like.to(device)
        with torch.no_grad():
            for _, p in like.named_parameters():
                leaf = leaves.pop(0)
                if D.is_dtensor(p):
                    p.to_local().copy_(_shard(leaf.to(p.dtype), p).to_local())
                else:
                    p.copy_(leaf)
        return like
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves, device)
                            for f in like._fields))
    if isinstance(like, Mapping):
        return {k: _unflatten(v, leaves, device) for k, v in like.items()}
    leaf = leaves.pop(0)
    if D.is_dtensor(like):
        return _shard(leaf, like)
    if isinstance(like, torch.Tensor):
        return leaf.to(device)
    return type(like)(leaf.item())


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array (bf16 as float32) and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        if D.is_dtensor(leaf):
            leaf = leaf.detach().full_tensor()
        t = leaf.detach().to("cpu", copy=True)  # a snapshot, even on the CPU
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_host(tree) -> List[Tuple[str, np.ndarray, str]]:
    return [(path,) + _host(leaf) for path, leaf in _flatten(tree)]


def _write(directory: str, step: int, host, aux: Optional[dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "shard_00000.npz"),
             **{f"leaf_{i}": arr for i, (_, arr, _) in enumerate(host)})
    manifest = {
        "step": int(step),
        "n_leaves": len(host),
        "treedef": [path for path, _, _ in host],
        "dtypes": {f"leaf_{i}": dt for i, (_, _, dt) in enumerate(host)},
        "aux": aux or {},
        "time": time.time(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    # flip LATEST last
    latest_tmp = os.path.join(directory, f".LATEST.tmp-{uuid.uuid4().hex[:8]}")
    with open(latest_tmp, "w") as f:
        f.write(f"step_{step:08d}")
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    return final


def save_checkpoint(directory: str, step: int, tree,
                    aux: Optional[dict] = None) -> str:
    """Synchronous save with atomic rename; returns the step's directory.
    On a mesh every rank calls it; it returns once rank 0 has written."""
    host = _to_host(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    if _writes():
        final = _write(directory, step, host, aux)
    barrier()
    return final


def latest_step(directory: str) -> Optional[int]:
    """The step ``LATEST`` points at, if its directory exists."""
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[1])


def load_checkpoint(directory: str, tree_like, step: Optional[int] = None,
                    device=None, placements=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like`` on ``device`` (default:
    the device of its first tensor leaf).  Returns ``(tree, aux)``; the
    leaves are cast back to their recorded dtypes.  A DTensor leaf of
    ``tree_like`` is re-sharded as it is laid out; ``placements`` maps a
    leaf's path to ``(mesh, placements)`` to lay a plain leaf out as a
    DTensor instead (tensors outside a module)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    like = _flatten(tree_like)
    paths = [path for path, _ in like]
    if manifest["treedef"] != paths:
        raise ValueError(f"checkpoint {d} holds leaves "
                         f"{manifest['treedef'][:4]}..., the state "
                         f"{paths[:4]}... ({manifest['n_leaves']} against "
                         f"{len(paths)})")
    if device is None:
        device = next((leaf.device for _, leaf in like
                       if isinstance(leaf, torch.Tensor)), "cpu")
    leaves = []
    with np.load(os.path.join(d, "shard_00000.npz")) as data:
        for i, (path, want) in enumerate(like):
            arr = data[f"leaf_{i}"]
            if isinstance(want, torch.Tensor) and \
                    tuple(arr.shape) != tuple(want.shape):
                raise ValueError(f"checkpoint {d}: {path} has shape "
                                 f"{arr.shape}, the state "
                                 f"{tuple(want.shape)}")
            dtype = getattr(torch, manifest["dtypes"][f"leaf_{i}"])
            leaves.append(torch.from_numpy(arr).to(dtype))
    if placements:
        tree_like = _with_layout(tree_like, placements)
    return _unflatten(tree_like, leaves, torch.device(device)), \
        manifest["aux"]


def _with_layout(tree, placements, prefix: str = ""):
    """``tree`` with each tensor leaf named in ``placements`` replaced by
    an empty DTensor of that layout (a template for :func:`_unflatten`)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, nn.Module):
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_with_layout(getattr(tree, f), placements,
                                         f"{prefix}{f}/")
                            for f in tree._fields))
    if isinstance(tree, Mapping):
        return {k: _with_layout(v, placements, f"{prefix}{k}/")
                for k, v in tree.items()}
    path = prefix.rstrip("/")
    if path in placements and isinstance(tree, torch.Tensor):
        mesh, pl = placements[path]
        return DTensor.from_local(torch.empty(0, device=mesh.device_type),
                                  mesh, pl, run_check=False,
                                  shape=tree.shape, stride=tree.stride())
    return tree


class CheckpointManager:
    """Async save with one write in flight, keeping the last ``keep``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    def wait(self):
        """Join the write in flight; raise its error, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            e, self._last_error = self._last_error, None
            raise e

    def save_async(self, step: int, tree, aux: Optional[dict] = None):
        self.wait()  # back-pressure: one in flight
        host = _to_host(tree)   # every rank of a mesh joins the gathers
        if not _writes():
            return

        def work():
            try:
                _write(self.directory, step, host, aux)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and ".tmp" not in n)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
