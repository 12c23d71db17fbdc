"""Multi-process smoke: one process per rank, through the CLI's `--dist`
plumbing.

    python -m gsrast_tpu_torch.diag.multihost_smoke --coord localhost:PORT \\
        --nprocs 2 --rank R [--device cuda|cpu] [--backend gloo|nccl]

Counterpart of the reference's `scripts/multihost_smoke.py`: the bootstrap
(`cli._maybe_distributed` -> `parallel.mesh.initialize_distributed`, which
picks the process-group backend for `--device` unless `--backend` names
one: two ranks on one card take gloo), a mesh over every rank, one
all_reduce across them, and one small tile-sharded render (the fused
multi-tier path, 256 Gaussians at 256x64, the scene drawn from a fixed
seed). Each rank prints `MULTIHOST_OK <sum of the image>`; all must print
the same. Throughput means nothing here: the ranks share one host.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

TIERS = ((2, 1.0), (8, 0.5), (32, 0.25))
WIDTH, HEIGHT = 256, 64


def smoke_scene_camera(device):
    """The smoke's scene and camera: 256 SH-0 Gaussians from
    `numpy.random.default_rng(0)`, seen from (0, 0, -3)."""
    from ..camera import look_at, make_camera
    from ..scene.gaussians import random_scene

    scene = random_scene(256, np.random.default_rng(0), sh_degree=0,
                         scale_range=(0.03, 0.1), device=device)
    camera = make_camera(look_at([0.0, 0.0, -3.0], [0.0, 0.0, 0.0],
                                 device=device), 1.2, 1.0, WIDTH, HEIGHT,
                         device=device)
    return scene, camera


def smoke_config(device):
    from ..config import RenderConfig

    return RenderConfig(tiers=TIERS, backend=(
        "cuda" if torch.device(device).type == "cuda" else "torch"))


def main(argv: Optional[list] = None) -> float:
    """Run this rank; returns the image sum it prints."""
    ap = argparse.ArgumentParser(prog="python -m gsrast_tpu_torch.diag."
                                      "multihost_smoke")
    ap.add_argument("--coord", required=True, help="rank 0's host:port")
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="process-group backend (default: "
                         "initialize_distributed's rule for --device)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .. import cli
    from ..parallel import comm, make_mesh, render_tile_sharded
    from ..parallel.mesh import rank_device

    device = cli._device(args.device)
    ns = argparse.Namespace(dist=f"{args.coord},{args.nprocs},{args.rank}",
                            device=args.device)
    backend = cli._maybe_distributed(ns, backend=args.backend)
    if args.nprocs > 1:
        device = rank_device(device)
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    assert world == args.nprocs, (world, args.nprocs)
    mesh = make_mesh((1, world)) if dist.is_initialized() else None

    if mesh is not None:
        ones = torch.ones((world,), device=device)
        total = comm.all_reduce_sum(ones, mesh, "tiles")
        assert float(total[0]) == float(world), total

    scene, camera = smoke_scene_camera(device)
    rcfg = smoke_config(device)
    with torch.no_grad():
        if mesh is None:
            from ..render.api import render

            image = render(scene, camera, rcfg).image
        else:
            image = render_tile_sharded(scene.activated(), camera, rcfg,
                                        mesh).image
        loss = float(torch.sum(image))
    print(f"rank {args.rank} of {world} on {device} (backend {backend}, "
          f"transports {comm.transports})", flush=True)
    print(f"MULTIHOST_OK {loss:.6f}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return loss


if __name__ == "__main__":
    main()
