"""Shared fixtures of the benchmark's own tests (run with `python -m pytest
gsbench/tests`; those marked `cuda` need a card and skip without one)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """Skip where there is no CUDA card (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"


def tiny(name: str):
    """Cell `name` of BENCHMARK.json cut to a CPU's size: 3,000 splats of
    a drawn cube (the trained scene as it is) at 128x96, eight poses, a
    tier plan for them, few warm and traced steps."""
    from gsbench import harness

    cell = harness.load(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["image"] = {"width": 128, "height": 96}
    if cell.config["scene"]["kind"] == "random_cube":
        cell.config["scene"].update(n=3000, scale_range=[0.01, 0.04])
    t = cell.traffic = copy.deepcopy(cell.traffic)
    t["poses"]["count"] = 8
    t.update(warm_steps=1, trace_steps=2, eager_steps=1, warm_frames=2,
             keep_every=2, trace_frames=2)
    cell.settings = copy.deepcopy(cell.settings)
    cell.settings["render"] = {"tile_h": 16, "tile_w": 32,
                               "tiers": [[4, 1.0], [96, 0.5]]}
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
