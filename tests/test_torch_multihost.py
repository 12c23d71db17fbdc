"""The port's multi-process smoke (`gsrast_tpu_torch.diag.multihost_smoke`)
as two gloo CPU processes through the CLI's --dist plumbing: both ranks
bootstrap, all_reduce across each other, render the tile-sharded image and
print the same sum, which equals the single-process render's within 1e-5
relative."""

import os
import subprocess
import sys

import numpy as np
import torch

from gsrast_tpu_torch.diag import multihost_smoke
from gsrast_tpu_torch.render.api import render

from torch_parity import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_bootstrap_all_reduce_render():
    coord = f"localhost:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gsrast_tpu_torch.diag.multihost_smoke",
         "--coord", coord, "--nprocs", "2", "--rank", str(r), "--device",
         "cpu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        assert "backend gloo (CPU ranks)" in out, out
    losses = [float(line.split()[1]) for out in outs
              for line in out.splitlines() if line.startswith("MULTIHOST_OK")]
    assert len(losses) == 2 and losses[0] == losses[1], losses

    scene, camera = multihost_smoke.smoke_scene_camera("cpu")
    with torch.no_grad():
        single = float(torch.sum(render(
            scene, camera, multihost_smoke.smoke_config("cpu")).image))
    assert single > 0
    np.testing.assert_allclose(losses[0], single, rtol=1e-5)
