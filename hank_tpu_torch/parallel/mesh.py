"""Device mesh over `torch.distributed` (port of `hank_tpu/parallel/mesh.py`).

One process per device (SPMD): each rank holds its block of the sharded
axis and the collectives are explicit. The reference's mesh is a
`jax.sharding.Mesh` whose `NamedSharding`s let XLA insert the collectives;
here a mesh is a `torch.distributed.device_mesh.DeviceMesh`, and its two
sharding specs become the two operations the port needs: `shard_rows` (this
rank's block of the leading axis, the reference's `ensemble_sharding`) and
`gather_rows` (the full axis on every rank, its `replicated_sharding`).
`all_reduce_scalar` carries the decisions a lockstep loop takes over the
whole batch.

The data-parallel axis "dp" shards shock paths (`parallel/ensemble.py`) and
the J̄ seed sweeps (`solvers/ss_jacobian.py`); the "state" axis shards the
household state (`parallel/state_sharding.py`).
"""

from __future__ import annotations

import datetime
import math
import os
import shutil
import tempfile
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# How long a collective waits for the other ranks before it fails.
TIMEOUT = datetime.timedelta(seconds=120)

# The temporary directory of a one-rank group's FileStore, removed by
# `destroy_distributed`.
_store_dir: str | None = None


def init_distributed(device=None, timeout: datetime.timedelta = TIMEOUT,
                     init_file: str | None = None) -> torch.device:
    """Start the default process group of this rank and return its device.

    NCCL on the card (the default), gloo when `device` is the CPU. A CUDA
    rank runs on `cuda:LOCAL_RANK`, set with `torch.cuda.set_device`. There
    is no fallback: without CUDA or NCCL a card rank raises RuntimeError.

    The rank and world size come from the launcher's environment (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, as `torchrun` sets them). The ranks meet
    through `init_file` (a `FileStore`) when it is given, else through
    `env://` (`MASTER_ADDR`/`MASTER_PORT`). With no launcher environment,
    the group is one rank, from a `FileStore` in a new temporary directory,
    so a plain `python` process runs the meshed paths on one device; end
    such a group with `destroy_distributed`, which removes the directory.
    Every collective of the group fails after `timeout`.
    """
    global _store_dir
    device = torch.device("cuda" if device is None else device)
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: a card rank needs CUDA, and "
                               "torch.cuda.is_available() is False")
        if not dist.is_nccl_available():
            raise RuntimeError("init_distributed: a card rank needs NCCL, and this "
                               "torch build has none")
        torch.cuda.set_device(local_rank)
        device, backend = torch.device("cuda", local_rank), "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: device {device} is neither the card nor the CPU")
    kw = dict(backend=backend, rank=rank, world_size=world, timeout=timeout)
    if backend == "nccl":
        kw["device_id"] = device
    if init_file is None and "RANK" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(init_method="env://", **kw)
    else:
        if init_file is None:
            if world != 1:
                raise ValueError(f"init_distributed: WORLD_SIZE={world} without "
                                 "MASTER_ADDR needs an init_file")
            _store_dir = tempfile.mkdtemp(prefix="hank_tpu_torch_pg_")
            init_file = os.path.join(_store_dir, "store")
        dist.init_process_group(store=dist.FileStore(init_file, world), **kw)
    return device


def destroy_distributed() -> None:
    """End the default process group, and remove the FileStore directory that
    `init_distributed` made for a one-rank group."""
    global _store_dir
    dist.destroy_process_group()
    if _store_dir is not None:
        shutil.rmtree(_store_dir, ignore_errors=True)
        _store_dir = None


def make_mesh(n_devices: int | None = None, axis_names: Sequence[str] = ("dp",)) -> DeviceMesh:
    """A 1-D (default) or 2-D mesh over the first `n_devices` ranks (all of
    them by default) of the default group, which must be started
    (`init_distributed`). Every rank of the group must call it, also the
    ranks it leaves out (for those, `mesh.get_coordinate()` is None).

    For two axis names the ranks form the reference's balanced grid
    a × n/a, a = ⌊√n⌋ lowered until it divides n
    (`hank_tpu/parallel/mesh.py:29-36`). The mesh's device type is that of
    the group's backend (NCCL: the card, gloo: the CPU).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no default process group; call init_distributed() first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: n_devices={n_devices} outside 1..{world} ranks")
    if len(axis_names) == 1:
        shape = (n,)
    elif len(axis_names) == 2:
        a = math.isqrt(n)
        while n % a:
            a -= 1
        shape = (a, n // a)
    else:
        raise ValueError(f"make_mesh: one or two axis names, got {tuple(axis_names)}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along `axis`."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def row_block(n_rows: int, mesh: DeviceMesh, axis: str = "dp") -> tuple[int, int]:
    """(first, count) of this rank's contiguous block of `n_rows` rows; raises
    ValueError when the mesh's size along `axis` does not divide n_rows."""
    size = _axis_size(mesh, axis)
    if n_rows % size:
        raise ValueError(f"{n_rows} rows do not split over the {size} ranks of "
                         f"mesh axis {axis!r}")
    count = n_rows // size
    return mesh.get_local_rank(axis) * count, count


def shard_rows(t: torch.Tensor, mesh: DeviceMesh, axis: str = "dp") -> torch.Tensor:
    """This rank's contiguous block of the leading axis of `t` (a view);
    ValueError when the mesh's size along `axis` does not divide it."""
    first, count = row_block(t.shape[0], mesh, axis)
    return t[first:first + count]


def gather_rows(t: torch.Tensor, mesh: DeviceMesh, axis: str = "dp") -> torch.Tensor:
    """Every rank's block of the leading axis, in rank order, on every rank:
    one all-gather (the inverse of `shard_rows`)."""
    t = t.contiguous()
    out = t.new_empty((_axis_size(mesh, axis) * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=mesh.get_group(axis))
    return out


def all_reduce_scalar(value: float, op: str, mesh: DeviceMesh, axis: str = "dp") -> float:
    """`value` reduced over the ranks of `axis` by `op` ("sum", "max" or
    "min"), the same on every rank. The value travels as float64, exact for
    counts below 2**53."""
    t = torch.tensor([float(value)], dtype=torch.float64, device=_mesh_device(mesh))
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                           "min": dist.ReduceOp.MIN}[op], group=mesh.get_group(axis))
    return float(t.item())
