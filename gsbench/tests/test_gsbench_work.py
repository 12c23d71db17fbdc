"""The frozen work counts against cases worked by hand."""

import math

import numpy as np
import pytest
import torch

from gsbench.reference import splat
from gsbench.work import model, shares


def test_preprocess_counts():
    # One splat, SH 0: 150 + 3 x 3 x 1 operations; 45 + 12 input bytes,
    # 60 written.
    assert model.preprocess("forward", 1, 1, 1) == (159, 117)
    # Backward at SH 3 (16 used of 16): 400 + 10 x 3 x 16 operations;
    # inputs 45 + 192 less the opacity, 36 of cotangents, 44 + 192 + 8
    # written.
    assert model.preprocess("backward", 2, 16, 16) == (
        2 * 880, 2 * (233 + 36 + 44 + 192 + 8))


def test_loss_and_adam_counts():
    assert model.loss("forward", 2, 2) == (12 * 246, 8 * 12 + 4)
    assert model.loss("backward", 2, 2) == (12 * 402, 12 * 12 + 4)
    assert model.adam(59, 1, 5) == (59 * 16, 28 * 59 + 1 + 40)
    assert model.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert model.bound_s(0, 67e12) == pytest.approx(1.0)


def test_blend_counts_of_one_splat():
    """One round splat of opacity 0.5 and sigma 3 px centred in a 16x32
    tile: every pixel walks its one position; it blends where
    0.5 exp(-d^2 / 18) >= 1/255, counted here by brute force."""
    sigma, op = 3.0, 0.5
    feats = torch.tensor([[15.0, 7.0, 1 / sigma ** 2, 0.0, 1 / sigma ** 2,
                           op, 0.2, 0.3, 0.4]])
    pr = splat.Pairs(torch.tensor([0]), torch.tensor([0, 1]), 1, 1, 0)
    cam = splat.Camera(*([None] * 7), width=32, height=16)
    out = splat.blend(feats, pr, cam, 16, 32)
    y, x = np.mgrid[0:16, 0:32]
    d2 = (x - 15.0) ** 2 + (y - 7.0) ** 2
    alpha = np.minimum(op * np.exp(-d2 / (2 * sigma ** 2)), 0.99)
    blends = int((alpha >= 1 / 255).sum())
    assert (out.fwd_pairs, out.bwd_pairs) == (512, 512)
    assert out.fwd_blended == out.bwd_blended == blends
    work = model.blend(512, blends, 512, blends, 1, 1, 512)
    assert work["forward"] == (21 * blends + 4 * (512 - blends),
                               4 * (9 + 5 * 512 + 2))
    assert work["backward"][0] == 46 * blends + 4 * (512 - blends)


class _Window:
    def __init__(self, calls, seconds):
        self.calls, self.s = calls, seconds

    def count(self, name):
        return self.calls

    def seconds(self, *names):
        return self.s


def test_roofline_share_counts_calls_in_the_trace():
    # Two steps of bound 1 ms each; the trace saw one call of 4 ms: 25%.
    ctx = {"steps": 2, "window": _Window(1, 4e-3),
           "work": {"adam": {"bound_s": 2e-3, "flops": 0.0, "bytes": 0.0}}}
    assert shares.roofline_pct(ctx, "adam") == pytest.approx(25.0)
    ctx["window"] = _Window(0, 0.0)
    assert shares.roofline_pct(ctx, "adam") is None
    ctx.update(window_s=1.0, work={"a": {"flops": 67e10, "bytes": 0,
                                         "bound_s": 0}})
    assert math.isclose(shares.mfu_pct(ctx), 1.0)
