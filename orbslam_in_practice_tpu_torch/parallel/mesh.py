"""Process-group bring-up and the landmark-shard layout of distributed BA.

Port of ``orbslam_in_practice_tpu/parallel/mesh.py``. The JAX package runs
one process per host over a mesh of its local devices; here each process
(rank) drives one device and holds ``n_shards / world_size`` consecutive
landmark shards, the analogue of that process's slice of the mesh (the
JAX tests' 8 virtual devices in one process, or 2 processes of 4).
Collectives go over ``torch.distributed``: NCCL between GPUs, gloo between
CPU processes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


def initialize_multihost(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str = "nccl",
):
    """Join the process group at ``coordinator`` ("host:port", a TCP
    rendezvous) as rank ``process_id`` of ``num_processes``; ``backend``
    "nccl" for CUDA tensors, "gloo" for CPU ones. Nothing happens for a
    single process."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_processes, rank=process_id
    )


@dataclass(frozen=True)
class Mesh:
    """``n_shards`` landmark shards over ``world_size`` ranks: this rank
    holds shards [rank * local_shards, (rank + 1) * local_shards) on
    ``device``."""

    n_shards: int
    world_size: int
    rank: int
    device: torch.device

    @property
    def local_shards(self) -> int:
        return self.n_shards // self.world_size

    @property
    def distributed(self) -> bool:
        """Whether sums are all-reduced across ranks (a process group is
        initialised), even a group of one."""
        return dist.is_available() and dist.is_initialized()


def make_mesh(n_shards: int, device: torch.device | str = "cuda") -> Mesh:
    """The layout of ``n_shards`` landmark shards over the process group's
    ranks (one rank without a group); ``n_shards`` must be a multiple of
    the world size."""
    grouped = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if grouped else (1, 0)
    if n_shards < 1 or n_shards % world:
        raise ValueError(f"{n_shards} shards do not divide over {world} ranks")
    return Mesh(n_shards, world, rank, torch.device(device))
