"""Process groups and a (data, model) mesh over them.

Counterpart of ``speech_recognition_tpu/parallel/mesh.py``.  The JAX
package lays a ``jax.sharding.Mesh`` over its devices and lets GSPMD
insert the collectives; here every rank is a process (one per card on a
GPU host, a gloo process on the CPU), the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose axes are process
groups, and each sharded entry point takes this rank's slice
(:func:`batch_shard`, :func:`bank_shard`) and calls the collectives
itself.  ``'data'`` shards utterance batches, ``'model'`` the bank's
models.

On a card the backend is NCCL with one rank per card
(``torch.cuda.set_device(local_rank)``); :func:`make_mesh` never gives
way to gloo and never puts two ranks on one card.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["init_distributed", "make_mesh", "mesh_device", "axis_rank", "batch_shard",
           "bank_shard", "all_gather"]


def init_distributed(**kwargs) -> None:
    """``torch.distributed.init_process_group(**kwargs)``, a no-op where
    the default group is already initialized."""
    if not dist.is_initialized():
        dist.init_process_group(**kwargs)


def _local_rank() -> Tuple[int, int]:
    """``(local rank, ranks on this host)``: ``LOCAL_RANK`` /
    ``LOCAL_WORLD_SIZE`` where a launcher set them, else one host."""
    rank, world = dist.get_rank(), dist.get_world_size()
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axes: Tuple[str, str] = ("data", "model"),
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks of the
    default group (call :func:`init_distributed` first).

    The default shape puts every rank on the data axis.  Raises if the
    shape needs more ranks than the world has.  With ``device_type
    "cuda"`` the backend must be NCCL and this host must have a card for
    each of its ranks; the rank's card becomes the current device.  A
    rank outside the mesh gets a mesh whose coordinate is None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized (init_distributed)")
    world = dist.get_world_size()
    if shape is None:
        shape = (world, 1)
    need = 1
    for n in shape:
        need *= n
    if need > world:
        raise ValueError(f"mesh shape {tuple(shape)} needs {need} ranks, have {world}")
    if device_type == "cuda":
        backend = dist.get_backend()
        if backend != "nccl":
            raise ValueError(f"a cuda mesh needs the nccl backend, the group runs {backend}")
        local, n_local = _local_rank()
        n_cards = torch.cuda.device_count()
        if n_cards < n_local:
            raise ValueError(f"{n_local} ranks on this host but {n_cards} visible cards: "
                             "a cuda mesh puts one rank on each card")
        torch.cuda.set_device(local)
    elif device_type != "cpu":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    return DeviceMesh(device_type, torch.arange(need).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``; raises for a rank outside
    the mesh."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return mesh.get_local_rank(axis)


def _slice(x, axis_len: int, idx: int, what: str):
    n = x.shape[0]
    if n % axis_len:
        raise ValueError(f"{what} of {n} does not divide the mesh axis of {axis_len}")
    k = n // axis_len
    return x[idx * k:(idx + 1) * k]


def batch_shard(mesh: DeviceMesh, x, axis: str = "data"):
    """This rank's slice of ``x`` along its leading (batch) axis over the
    mesh's ``axis``, on the mesh's device.  Raises if the batch does not
    divide the axis."""
    x = torch.as_tensor(x)
    return _slice(x, _axis_size(mesh, axis), axis_rank(mesh, axis), "a batch").to(
        mesh_device(mesh))


def bank_shard(mesh: DeviceMesh, bank, shard_models: bool = False):
    """The bank this rank holds, on the mesh's device: the whole bank, or
    with ``shard_models`` its slice of models along ``'model'`` (raises
    if the model count does not divide that axis)."""
    dev = mesh_device(mesh)
    params = (bank.means, bank.log_vars, bank.log_weights, bank.trans_cost)
    if shard_models:
        n, idx = _axis_size(mesh, "model"), axis_rank(mesh, "model")
        params = [_slice(p, n, idx, "a bank") for p in params]
    return type(bank)(*[p.to(dev) for p in params])


def all_gather(x, group=None) -> list:
    """Every rank's ``x`` of ``group`` (same shape everywhere), in rank
    order: the list form of ``torch.distributed.all_gather``."""
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return out
