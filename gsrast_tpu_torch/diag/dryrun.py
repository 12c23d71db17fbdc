"""The entry point and the multi-rank dry run: the port's counterpart of
the reference's `__graft_entry__.py` (`python __graft_entry__.py`).

    python -m gsrast_tpu_torch.diag.dryrun [--n 8] [--device cuda|cpu]
        [--entry-gaussians 100000 --entry-width 1024 --entry-height 768]
        [--gaussians 16384 --width 1024 --height 128]

`entry()` returns (fn, args): fn(activated, view) is the image of `render`
on the flagship path (the fused multi-tier binning and the blend kernels)
for 100,000 SH-3 Gaussians at 1024x768, args the scene's activated
Gaussians and the camera's view. `dryrun_multichip(n)` runs on each of n
ranks of a process group: on the (data, tiles) mesh (2, n/2), or (1, n)
where n is odd or under 4, one data x tile train step with Adam, the
tile-sharded render's overflow audit and the primitive-sharded gradient,
on 16,384 SH-1 Gaussians at 1024x128; rank 0 prints the reference's
`dryrun_multichip ok: ...` line.

The command runs `entry` in this process and prints `entry ok: <shape>
<mean>`, then spawns n ranks (`torch.multiprocessing`) that run
`dryrun_multichip`: gloo ranks on the CPU; on the card NCCL where every
rank has a card of its own, else gloo ranks sharing the cards
(`parallel.mesh.choose_backend`). Scenes come from
`numpy.random.default_rng`, not the reference's `jax.random`, so the
numbers differ from the reference's; the tests pass the reference's arrays
in. `--device cuda` is the default and exits where there is no card.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import time
from typing import Optional

import numpy as np
import torch

ENTRY_TIERS = ((2, 1.0), (4, 0.8), (8, 0.4), (32, 0.15))
DRYRUN_TIERS = ((2, 1.0), (8, 1.0), (32, 1.0), (128, 1.0))
CAMERA_TENSORS = ("view", "fov_x", "fov_y", "znear", "zfar")
RANK_TIMEOUT = 900.0  # seconds a group of spawned ranks may take


def _backend(device) -> str:
    """The blend kernels on the card, their plain versions elsewhere."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def front_camera(width: int, height: int, dist: float, device):
    """The reference's camera: from (0, 0, -dist) at the origin, fov
    1.2 x 1.0."""
    from ..camera import look_at, make_camera

    return make_camera(look_at([0.0, 0.0, -dist], [0.0, 0.0, 0.0],
                               device=device), 1.2, 1.0, width, height,
                       device=device)


def entry_config(device):
    """The flagship path's config (`__graft_entry__.entry`): the fused
    multi-tier binning with ENTRY_TIERS, capacity factor 8."""
    from ..config import RenderConfig

    return RenderConfig(backend=_backend(device),
                        intersect_capacity_factor=8.0, tiers=ENTRY_TIERS)


def entry(n_gaussians: int = 100_000, width: int = 1024, height: int = 768,
          device="cuda"):
    """(fn, (activated, view)): fn(activated, view) -> the (H, W, 3) image
    of `render` with `entry_config` from the entry camera moved to `view`;
    the scene is `n_gaussians` anisotropic SH-3 Gaussians, scales in
    [0.005, 0.02], from `numpy.random.default_rng(0)`."""
    from ..render.api import render
    from ..scene.gaussians import random_scene

    scene = random_scene(n_gaussians, np.random.default_rng(0), sh_degree=3,
                         isotropic=False, scale_range=(0.005, 0.02),
                         device=device)
    camera = front_camera(width, height, 2.5, device)
    cfg = entry_config(device)

    def fn(activated, view):
        return render(activated, camera.replace(view=view), cfg).image

    return fn, (scene.activated(), camera.view)


def dryrun_config(device):
    """The dry run's config (`__graft_entry__.dryrun_multichip`): full tier
    budgets, a per-tile cap of 2,048 for the oracle, capacity factor 16."""
    from ..config import RenderConfig

    return RenderConfig(backend=_backend(device), max_per_tile=2048,
                        tile_chunk=4, intersect_capacity_factor=16.0,
                        tiers=DRYRUN_TIERS)


def mesh_shape(n_devices: int) -> tuple:
    """(2, n/2) for an even n of at least 4, else (1, n)."""
    if n_devices >= 4 and n_devices % 2 == 0:
        return 2, n_devices // 2
    return 1, n_devices


def dryrun_multichip(n_devices: int, scene=None, n_gaussians: int = 16_384,
                     width: int = 1024, height: int = 128, device="cuda",
                     min_intersections: int = 10_000) -> dict:
    """One sharded train step, the overflow audit and the primitive-sharded
    gradient on this rank of an initialized process group of `n_devices`
    ranks, every rank calling it alike. `scene`: a GaussianScene on this
    rank's device, by default `n_gaussians` SH-1 Gaussians, scales in
    [0.01, 0.05], from `numpy.random.default_rng(1)`. Asserts a finite
    loss and gradients, every overflow counter 0 and more than
    `min_intersections` (the reference's 10,000 at its size); returns the
    numbers of the printed line."""
    import torch.distributed as dist

    from ..parallel import comm, make_mesh
    from ..parallel.mesh import DATA_AXIS, TILE_AXIS, axis_size
    from ..parallel.sharded import (make_sharded_train_step, pad_gaussians,
                                    render_primitive_sharded,
                                    render_tile_sharded)
    from ..scene.gaussians import ActivatedGaussians, random_scene

    world = dist.get_world_size()
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) on {world} ranks")
    if scene is None:
        scene = random_scene(n_gaussians, np.random.default_rng(1),
                             sh_degree=1, scale_range=(0.01, 0.05),
                             device=device)
    mesh = make_mesh(mesh_shape(n_devices))
    n_data = axis_size(mesh, DATA_AXIS)
    cfg = dryrun_config(device)
    base = front_camera(width, height, 3.0, device)
    cams = base.replace(**{f: getattr(base, f).expand(
        n_data, *getattr(base, f).shape) for f in CAMERA_TENSORS})
    targets = torch.zeros((n_data, height, width, 3), device=device)
    with torch.no_grad():  # the scene before the step, for the audits
        act = ActivatedGaussians(**{
            k: v.clone() for k, v in vars(scene.activated()).items()})

    optimizer = torch.optim.Adam(scene.parameters(), lr=1e-3)
    step = make_sharded_train_step(cfg, mesh, height, width,
                                   cameras_per_device=1, optimizer=optimizer)
    loss, grads = step(scene, cams, targets)
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    assert bool(torch.isfinite(loss)), f"non-finite loss {float(loss)}"
    assert bool(torch.isfinite(gnorm)), "non-finite grads"

    # The overflow audit of the tile-sharded render at the same scale.
    with torch.no_grad():
        stats = render_tile_sharded(act, base, cfg, mesh).stats
    n_tile_isect = int(stats["num_intersections"])
    overflow = {key: int(stats[key]) for key in (
        "overflow_capacity", "overflow_tile_cap", "overflow_per_tile")}
    for key, count in overflow.items():
        assert count == 0, f"{key}={count} at dryrun scale"
    assert n_tile_isect > min_intersections, (
        f"dryrun scene too trivial: {n_tile_isect} intersections")

    # Primitive sharding on this rank's row of the mesh, a (1, n_tile) mesh
    # of its own: d/d means of mean(image), each rank its shard's.
    row = mesh[TILE_AXIS]
    n_tile, d = axis_size(row, TILE_AXIS), row.get_local_rank(TILE_AXIS)
    padded = pad_gaussians(act, n_tile)
    nl = padded.means.shape[0] // n_tile
    shard = {k: v[d * nl:(d + 1) * nl] for k, v in vars(padded).items()}
    means = shard.pop("means").clone().requires_grad_(True)
    out = render_primitive_sharded(ActivatedGaussians(means=means, **shard),
                                   base, cfg, row)
    ploss = torch.mean(out.image)
    ploss.backward()
    finite = torch.isfinite(ploss) & torch.all(torch.isfinite(means.grad))
    finite = comm.all_reduce_sum(finite.to(torch.int32)[None], row,
                                 TILE_AXIS)
    assert int(finite[0]) == n_tile, "primitive-sharded loss/grads not finite"

    res = {"mesh": {DATA_AXIS: n_data, TILE_AXIS: axis_size(mesh, TILE_AXIS)},
           "width": width, "height": height, "capacity": scene.capacity,
           "backend": cfg.backend, "loss": float(loss),
           "grad_norm": float(gnorm), "tile_intersections": n_tile_isect,
           **overflow,
           "prim_loss": float(ploss.detach()),
           "prim_intersections": int(out.stats["num_intersections"])}
    if dist.get_rank() == 0:
        print(dryrun_line(res), flush=True)
    return res


def dryrun_line(res: dict) -> str:
    """The reference's summary line of `dryrun_multichip`."""
    return (f"dryrun_multichip ok: mesh={res['mesh']} {res['width']}x"
            f"{res['height']}/{res['capacity']}g backend={res['backend']} "
            f"loss={res['loss']:.5f} grad_norm={res['grad_norm']:.5f} "
            f"tile_sharded: isect={res['tile_intersections']} overflow=0 "
            f"prim_sharded[{res['backend']}]: loss={res['prim_loss']:.5f} "
            f"intersections={res['prim_intersections']}")


# -- ranks -------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, queue, fn, device: str,
               kwargs: dict) -> None:
    """A spawned rank: joins the group at tcp://localhost:`port`
    (`initialize_distributed`: NCCL where every rank has a card of its own,
    else gloo; on the card, card rank % the cards), runs
    fn(world, this rank's device, **kwargs) and puts (rank, its result) on
    the queue."""
    import torch.distributed as dist

    from ..parallel.mesh import initialize_distributed, rank_device

    dev = rank_device(device, rank)
    if dev.type == "cpu":  # ranks share the host's cores
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // world)))
    initialize_distributed(f"localhost:{port}", world, rank, device=dev.type,
                           group_of_one=True)
    try:
        queue.put((rank, fn(world, dev, **kwargs)))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, device, timeout: float = RANK_TIMEOUT,
                **kwargs) -> list:
    """fn(world, device, **kwargs) (a module-level function) on `world`
    spawned ranks of one process group on `device` ('cuda' or 'cpu');
    returns each rank's result, in rank order. Raises if a rank fails, or
    kills them all past `timeout` seconds."""
    import torch.multiprocessing as mp

    queue = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(
        _rank_main, args=(world, free_port(), queue, fn,
                          torch.device(device).type, kwargs),
        nprocs=world, join=False, start_method="spawn")
    results = {}
    deadline = time.monotonic() + timeout
    done = False
    while not done:
        done = ctx.join(timeout=1)
        while not queue.empty():
            rank, res = queue.get()
            results[rank] = res
        if not done and time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise RuntimeError(
                f"{fn.__name__}: {world} ranks past {timeout} s")
    return [results[r] for r in range(world)]


def _dryrun_rank(world: int, device, **kwargs) -> dict:
    """`dryrun_multichip` on a spawned rank, with the rank's kernel
    launches."""
    from .. import _kernels

    _kernels.reset_launch_counts()
    res = dryrun_multichip(world, device=device, **kwargs)
    return dict(res, launches=dict(_kernels.launch_counts))


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gsrast_tpu_torch.diag.dryrun")
    ap.add_argument("--n", type=int, default=8,
                    help="ranks of the dry run (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--entry-gaussians", type=int, default=100_000)
    ap.add_argument("--entry-width", type=int, default=1024)
    ap.add_argument("--entry-height", type=int, default=768)
    ap.add_argument("--gaussians", type=int, default=16_384)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--min-intersections", type=int, default=10_000)
    args = ap.parse_args(argv)
    from ..cli import _device

    device = _device(args.device)
    fn, fn_args = entry(args.entry_gaussians, args.entry_width,
                        args.entry_height, device)
    with torch.no_grad():
        out = fn(*fn_args)
    print("entry ok:", tuple(out.shape), float(out.mean()), flush=True)
    del fn, fn_args, out
    spawn_ranks(_dryrun_rank, args.n, device,
                n_gaussians=args.gaussians, width=args.width,
                height=args.height, min_intersections=args.min_intersections)
    return 0


if __name__ == "__main__":
    sys.exit(main())
