"""Process groups, the (data, model) mesh and batch sharding: the port of
``nhans_tpu/parallel/mesh.py``.

The JAX package runs one program over a device mesh; the port runs one
process per rank under ``torch.distributed`` (NCCL between cards, gloo on
the CPU).  A rank is one device.  The mesh lays the world out as
``data x model`` ranks, rank ``d * model + m`` at data index ``d`` and
model index ``m``, as ``make_mesh`` of the JAX package reshapes its
device list:

* the **data** group of a rank holds the ranks with its model index: the
  batch is split over it, and gradients, the loss and BatchNorm's moments
  are summed over it;
* the **model** group holds the ranks with its data index: they see the
  same rows, and the wide layers' output channels are split over it
  (``parallel/sharding_rules.py``).

``initialize_multihost`` joins the world: under ``torchrun`` from the
environment, else from an address (``host:port``, or a ``file://`` or
``tcp://`` URL), the world size and this process's rank.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_world_size() -> int:
    """Ranks on this node: ``LOCAL_WORLD_SIZE`` (``torchrun`` sets it);
    without it every rank counts as a node of its own."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", "1"))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """Join the ``torch.distributed`` world, once per process.

    With no address the world comes from the environment (``env://``, as
    ``torchrun`` sets it).  ``backend`` None picks NCCL where CUDA is
    available and gloo otherwise; NCCL needs a card for every rank of the
    node, so two ranks that share one card pass ``backend="gloo"`` (gloo
    moves CUDA tensors through the host).  With NCCL the rank's card,
    ``cuda:{LOCAL_RANK}``, becomes the current device."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and local_world_size() > torch.cuda.device_count():
        raise ValueError(
            f"{local_world_size()} ranks on this node but "
            f"{torch.cuda.device_count()} CUDA device(s): NCCL needs a card "
            "for every rank; pass backend='gloo' to share cards")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def process_shard(items: list, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> list:
    """Process ``i`` of ``n`` reads ``items[i::n]``; the full list where
    that slice would be empty (tiny manifests).  The defaults are this
    rank and the world size."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    shard = items[pi::pc]
    return shard if shard else list(items)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the ``data x model`` layout and its two
    process groups: None without a ``torch.distributed`` world, so that no
    collective runs; within a world every axis has its group, one of a
    single rank included (a world of one then runs its collectives too)."""

    data: int
    model: int
    rank: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def is_primary(self) -> bool:
        """Rank 0: the one that writes checkpoints, records and prints."""
        return self.rank == 0


def _groups(ranks_of: List[List[int]], mine: int):
    """``dist.new_group`` for every list in ``ranks_of`` (every rank must
    create every group, in the same order); the one holding ``mine``, or
    None without a world."""
    if not dist.is_initialized():
        return None
    found = None
    for ranks in ranks_of:
        g = dist.new_group(ranks)
        if mine in ranks:
            found = g
    return found


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The mesh over the world's ranks; ``data`` None or 0 takes the world
    divided by ``model``.  ``data * model`` must be the world size: a
    rank outside the mesh would have no work."""
    world = world_size()
    model = int(model)
    if model < 1:
        raise ValueError(f"make_mesh: model={model} must be at least 1")
    if data is None or data <= 0:
        data = world // model
    if data < 1 or data * model != world:
        raise ValueError(
            f"make_mesh: requested data={data} x model={model} = "
            f"{data * model} ranks but the world has {world}; start "
            f"data x model processes (torchrun --nproc_per_node, or "
            f"--multihost --num_processes)")
    r = rank()
    data_group = _groups([[d * model + m for d in range(data)]
                          for m in range(model)], r)
    model_group = _groups([[d * model + m for m in range(model)]
                           for d in range(data)], r)
    return Mesh(data, model, r, data_group, model_group)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """Utterances a rank feeds: the global batch divided over the data
    axis, rounded up."""
    return -(-int(global_batch) // mesh.data)


def shard_rows(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous block of ``n`` rows split over the data axis
    (the JAX package's ``PartitionSpec("data")``)."""
    if n % mesh.data:
        raise ValueError(f"{n} rows do not split over data={mesh.data}")
    per = n // mesh.data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(mesh: Mesh, batch: Dict[str, object]) -> Dict[str, object]:
    """This rank's rows of a global batch (a dict of arrays or tensors
    with the batch on the leading axis)."""
    return {k: v[shard_rows(int(v.shape[0]), mesh)]
            for k, v in batch.items()}


def all_reduce_mean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``t`` over ``group`` (``t`` itself where the group is
    None), in float32; gloo and NCCL both take it on CUDA tensors."""
    if group is None:
        return t
    out = t.detach().to(torch.float32).clone()
    dist.all_reduce(out, group=group)
    return (out / dist.get_world_size(group)).to(t.dtype)


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()
