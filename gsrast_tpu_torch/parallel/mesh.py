"""The (data, tiles) mesh over `torch.distributed`, and the process
bootstrap. Port of `gsrast_tpu/parallel/mesh.py`.

Axes:
  * "data"  - the camera/image batch (data-parallel training; gradients
    sum over it)
  * "tiles" - image-space tile sharding: each rank blends the tile rows it
    owns (the renderer's sequence-parallel analog)

One rank of the mesh is one process. `make_mesh` lays the ranks of the
initialized process group out as a `DeviceMesh` with those axis names: a
rank's coordinate along an axis is `mesh.get_local_rank(axis)`, the axis's
subgroup `mesh.get_group(axis)`, its size `axis_size(mesh, axis)`.

The reference's `replicated_sharding` and `tile_sharding` name JAX
shardings for placing one array across devices. Here no array spans
processes: each rank holds its own tensors and the collectives of
`parallel.comm` move them, so they have no counterpart.

Process-group backends: NCCL refuses two ranks of one communicator on the
same GPU, so `initialize_distributed` takes NCCL only where every rank can
own a card, and gloo for CPU ranks or ranks that share one. The choice is
made once, up front, and printed; nothing tries one backend and falls back
to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
TILE_AXIS = "tiles"
AXES = (DATA_AXIS, TILE_AXIS)


def choose_backend(device, num_processes: int) -> Tuple[str, str]:
    """(backend, reason) for `num_processes` ranks on `device` ('cuda' or
    'cpu'): NCCL where the host has a card for every rank, gloo for CPU
    ranks or ranks that share a card. A run spread over hosts with fewer
    cards than ranks each names its backend instead."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo", "CPU ranks"
    cards = torch.cuda.device_count()
    if cards >= num_processes:
        return "nccl", f"{num_processes} ranks, {cards} cards: one each"
    return "gloo", (f"{num_processes} ranks share {cards} card(s); NCCL "
                    "takes one rank per GPU")


def rank_device(device, rank: Optional[int] = None) -> torch.device:
    """The device of `rank` (this process's where None): for 'cuda', card
    rank % the host's card count, so ranks beyond the cards share them."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device="cuda") -> Optional[str]:
    """Multi-process bootstrap; a no-op for one process (returns None).

    Otherwise joins the process group at `tcp://<coordinator_address>`
    (`host:port`, rank 0 listening) as rank `process_id` of
    `num_processes`, with `backend`, or where None the one
    `choose_backend` gives for `device`; prints the choice and returns the
    backend. A CUDA rank's current card is set first (`rank_device`)."""
    if num_processes is None or num_processes <= 1:
        return None
    reason = "named by the caller"
    if backend is None:
        backend, reason = choose_backend(device, num_processes)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device, process_id))
    print(f"initialize_distributed: rank {process_id} of {num_processes} at "
          f"tcp://{coordinator_address}, backend {backend} ({reason})",
          flush=True)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return backend


def make_mesh(shape: Optional[Tuple[int, int]] = None):
    """The (data, tiles) `DeviceMesh` over every rank of the initialized
    process group, rank r at (r // shape[1], r % shape[1]). Default: all
    ranks on the tile axis. Collective: every rank calls it, in the same
    order as its other meshes."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    shape = (1, n) if shape is None else tuple(shape)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    # The mesh only carries the ranks and their groups, whose backend is the
    # world's; 'cuda' for NCCL, else 'cpu' (gloo ranks may still hold CUDA
    # tensors, see parallel.comm).
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[AXES.index(axis)]
