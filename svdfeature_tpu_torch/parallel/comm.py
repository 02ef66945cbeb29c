"""The mesh's processes and collectives: the port's counterpart of
``jax.sharding.Mesh``, ``jax.lax.psum`` / ``all_gather`` and
``NamedSharding`` (svdfeature_tpu/parallel/mesh.py).

JAX runs a ``(data, model)`` mesh inside one process (``shard_map`` over
its devices).  The port runs one process per mesh position under
torch.distributed, launched by torchrun::

    python -m torch.distributed.run --nproc_per_node=4 \\
        -m svdfeature_tpu_torch.cli.svd_feature my.conf distributed=1 mesh_data=2 mesh_model=2

- **Ranks.**  The world has ``n_data * n_model`` ranks; rank ``r = d *
  n_model + m`` (JAX ``make_mesh``'s row-major order, mesh.py:75).  Each
  rank is in one ``model`` group (the ranks of one ``d``: the row shards
  of the table that score one slice of the batch) and one ``data`` group
  (the ranks of one ``m``: the data replicas of one row shard).
- **Device and backend.**  A rank trains on ``cuda:{LOCAL_RANK %
  device_count}``.  The backend is NCCL when the node has at least as many
  cards as local ranks, else gloo on the CUDA tensors: NCCL refuses two
  ranks on one device, so ranks that share a card talk through gloo.  On
  ``device=cpu`` it is gloo.  The rule is printed at start-up by rank 0.
- **Collectives.**  ``psum`` is one ``all_reduce`` of the concatenated
  tensors (one dtype).  ``all_gather`` is one ``all_gather`` of the
  concatenated tensors, stacked in group order; tensors of several 4-byte
  dtypes (int32 ids beside f32 floats) travel as their bits in one call.
  Both backends take CPU and CUDA tensors for it.  A group of one rank
  makes no collective.

Every rank must create every group, in the same order, groups it is not in
included (``make_mesh``), or the ranks hang.  ``init_process_group`` gets a
timeout, so a rank that dies ends the others' collectives with an error.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TIMEOUT_S = 300  # of every collective: a dead rank fails the others, never hangs them


def _torchrun_hint(n: int) -> str:
    return (f"launch {n} ranks with torchrun: python -m torch.distributed.run "
            f"--nproc_per_node={n} -m svdfeature_tpu_torch.cli.svd_feature <conf> "
            f"distributed=1 ...")


def check_world(need: int) -> None:
    """Raise ValueError unless this process is one of a world of ``need``
    ranks (WORLD_SIZE, or the initialized process group): the counterpart
    of the JAX trainer's "exceeds N devices" (solvers/base.py:243-246)."""
    world = dist.get_world_size() if dist.is_initialized() else os.environ.get("WORLD_SIZE")
    if world is None or int(world) != need:
        raise ValueError(f"mesh_data*mesh_model={need} needs a world of {need} ranks, but "
                         f"WORLD_SIZE is {world}: {_torchrun_hint(need)}")


def init_distributed(device_name: str = "cuda") -> bool:
    """Join the torchrun world (env:// rendezvous: RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT; LOCAL_RANK and LOCAL_WORLD_SIZE for the
    card).  On a CUDA device the rank's card becomes the current device
    before any tensor is made on it.  Idempotent; returns True when the
    world has more than one rank.  The ``distributed=1`` key of the train
    and infer tasks calls it, and so does a trainer with a mesh of more
    than one position."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if "WORLD_SIZE" not in env or "RANK" not in env:
        raise ValueError(f"distributed training needs a torchrun world (RANK and WORLD_SIZE "
                         f"unset): {_torchrun_hint(2)}")
    world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if torch.device(device_name).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device_name} but no CUDA device is available "
                               "(pass device=cpu to train on the CPU)")
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
        backend = "nccl" if cards >= local_world else "gloo"
        why = f"{local_world} local ranks on {cards} card(s): " + (
            "one card each" if backend == "nccl" else "ranks share a card, NCCL takes one a card")
    else:
        device, backend, why = torch.device("cpu"), "gloo", "CPU tensors"
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    atexit.register(shutdown)
    if rank == 0:
        print(f"distributed: {world} ranks, backend {backend} ({why}); rank {rank} on {device}",
              flush=True)
    return world > 1


def rank() -> int:
    """This process's rank in its world (0 outside one): rank 0 alone
    writes checkpoints, logs and predictions."""
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """Wait for every rank of the world (none outside one): what rank 0
    wrote is there for all when it returns."""
    if dist.is_initialized():
        dist.barrier()


def world_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank of the world (``x`` itself outside one)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        x = x.clone()
        dist.all_reduce(x)
    return x


def shutdown() -> None:
    """Leave the world (registered at exit by ``init_distributed``)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESHES.clear()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a ``(data, model)`` mesh: its coordinates and the
    two groups it is in (None for a group of one rank)."""

    n_data: int
    n_model: int
    d: int
    m: int
    groups: Dict[str, Optional[object]]
    device: torch.device

    def size(self, axis: str) -> int:
        return self.n_data if axis == "data" else self.n_model


# the groups of each mesh made in this process: every rank makes the same
# meshes in the same order, so every rank finds (or misses) the same entry
_MESHES: Dict[Tuple, Optional[Mesh]] = {}


def make_mesh(n_data: int, n_model: int, device: torch.device,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """The ``(data, model)`` mesh over ``ranks`` (default: the first
    ``n_data * n_model`` ranks of the world), position ``d * n_model + m``
    at ``ranks[d * n_model + m]``.  Every rank of the world calls it, in
    the same order, for every mesh; a rank outside ``ranks`` gets None."""
    ranks = list(range(n_data * n_model)) if ranks is None else list(ranks)
    if len(ranks) != n_data * n_model:
        raise ValueError(f"a {n_data}x{n_model} mesh needs {n_data * n_model} ranks, got {ranks}")
    key = (n_data, n_model, tuple(ranks), str(device))
    if key in _MESHES:
        return _MESHES[key]
    model_ranks = [ranks[d * n_model:(d + 1) * n_model] for d in range(n_data)]
    data_ranks = [ranks[m::n_model] for m in range(n_model)]
    # new_group is collective over the world: each rank makes each group
    made = {"model": [dist.new_group(r) if len(r) > 1 else None for r in model_ranks],
            "data": [dist.new_group(r) if len(r) > 1 else None for r in data_ranks]}
    me = dist.get_rank()
    mesh = None
    if me in ranks:
        d, m = divmod(ranks.index(me), n_model)
        mesh = Mesh(n_data, n_model, d, m, {"model": made["model"][d], "data": made["data"][m]},
                    device)
    _MESHES[key] = mesh
    return mesh


def _flat(tensors: Sequence[torch.Tensor], bits: bool = False) -> torch.Tensor:
    """The tensors concatenated; with ``bits``, tensors of 4-byte dtypes
    as their int32 bits (a gather moves bytes, so they come back exact)."""
    dtypes = {t.dtype for t in tensors}
    if bits and all(t.element_size() == 4 for t in tensors):
        return torch.cat([t.reshape(-1).view(torch.int32) for t in tensors])
    if len(dtypes) != 1:
        raise ValueError(f"one collective takes tensors of one dtype, got {dtypes}")
    return torch.cat([t.reshape(-1) for t in tensors])


def _split(flat: torch.Tensor, like: Sequence[torch.Tensor], lead=()) -> List[torch.Tensor]:
    """Cut the columns of ``flat [*lead, L]`` back into tensors shaped and
    typed as ``like`` (each with the leading dims ``lead``)."""
    out, at = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[..., at:at + n].view(t.dtype).reshape(*lead, *t.shape))
        at += n
    return out


def psum(mesh: Mesh, axis: str, *tensors: torch.Tensor) -> List[torch.Tensor]:
    """The sums of ``tensors`` over the ``axis`` group (``jax.lax.psum``),
    in one ``all_reduce``; the inputs are not changed."""
    group = mesh.groups[axis]
    if group is None:
        return list(tensors)
    flat = _flat(tensors)
    dist.all_reduce(flat, group=group)
    return _split(flat, tensors)


def all_gather(mesh: Mesh, axis: str, *tensors: torch.Tensor) -> List[torch.Tensor]:
    """``[n, *shape]`` stacks of ``tensors`` over the ``axis`` group in
    group order (``jax.lax.all_gather``), in one ``all_gather`` whatever
    their 4-byte dtypes."""
    group = mesh.groups[axis]
    if group is None:
        return [t[None] for t in tensors]
    flat = _flat(tensors, bits=True)
    parts = [torch.empty_like(flat) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, flat, group=group)
    return _split(torch.stack(parts), tensors, lead=(len(parts),))
