"""The frozen work model: the operations and bytes each kernel of a splat
train step or frame needs, and the least time one NVIDIA H100 could take
for them.

Peaks are NVIDIA's published figures for the H100 SXM part at its 700 W
limit: 67 TFLOP/s in float32 outside the tensor cores and 3.35 TB/s of HBM.
A bound is the larger of operations over the operation peak and bytes over
the byte peak; a kernel's roofline share is its bound over its measured
time. Operations are counted per element of work as the program's own
work model counts them (frozen here from `chip_smoke.py` of the program at
the time this benchmark was written); bytes count each input read once and
each output written once. Every count comes from shapes and from the
reference's counts over the cell's inputs, never from the program's
buffers, so a kernel that is fused, split or removed is held to the same
work.
"""

from __future__ import annotations

FP32_FLOPS = 67e12
HBM_BPS = 3.35e12

# The blend: operations a (pixel, position) pair at which the splat blends,
# forward and backward, and at a needed pair at which it does not (the box
# test); the expf is not counted.
BLEND_FWD_FLOPS = 21
BLEND_BWD_FLOPS = 46
BLEND_SKIP_FLOPS = 4
# The preprocess: operations a splat, and per used SH coefficient and
# channel.
PRE_FWD_FLOPS, PRE_BWD_FLOPS = 150, 400
PRE_SH_FLOPS = {"forward": 3, "backward": 10}
# The loss: operations an image element, forward and backward.
LOSS_FWD_FLOPS, LOSS_BWD_FLOPS = 246, 402
# The optimizer: operations a parameter float.
ADAM_FLOPS = 16


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds: the larger of bytes and operations over peak."""
    return max(nbytes / HBM_BPS, flops / FP32_FLOPS)


def blend(fwd_pairs: int, fwd_blended: int, bwd_pairs: int, bwd_blended: int,
          live: int, tiles: int, pixels: int) -> dict:
    """(flops, bytes) of the blend forward and backward over `live`
    ordered pairs on `tiles` tiles of `pixels` pixels: the forward reads 9
    features a pair and writes colour, transmittance and walk length a
    pixel; the backward reads the pairs, the pixels' colour cotangent,
    transmittance and walk length, and writes 9 gradients a pair."""
    return {
        "forward": (BLEND_FWD_FLOPS * fwd_blended
                    + BLEND_SKIP_FLOPS * (fwd_pairs - fwd_blended),
                    4 * (9 * live + 5 * tiles * pixels + tiles + 1)),
        "backward": (BLEND_BWD_FLOPS * bwd_blended
                     + BLEND_SKIP_FLOPS * (bwd_pairs - bwd_blended),
                     4 * (18 * live + 5 * tiles * pixels + tiles + 1)),
    }


def preprocess(kind: str, n: int, used: int, k: int) -> tuple:
    """(flops, bytes) of one preprocess kernel over n splats with `used` of
    their k SH coefficients evaluated, in a train step. Forward: means 12
    bytes, scales 12, quaternions 16, opacity 4, mask 1 and the used SH 12
    each, writing mean2d, depth, conic, colour, opacity, radius and rect
    (60 bytes). Backward: the same inputs but the opacity, the cotangents
    of mean2d, conic, colour and opacity (36 bytes), writing the gradients
    of the five inputs (44 bytes and 12 k of SH) and of the screen-space
    offset (8 bytes)."""
    inputs = 45 + 12 * used
    if kind == "forward":
        return n * (PRE_FWD_FLOPS + PRE_SH_FLOPS[kind] * 3 * used), n * (
            inputs + 60)
    return n * (PRE_BWD_FLOPS + PRE_SH_FLOPS[kind] * 3 * used), n * (
        inputs - 4 + 36 + 44 + 12 * k + 8)


def loss(kind: str, height: int, width: int, channels: int = 3) -> tuple:
    """(flops, bytes) of one loss kernel on an (H, W, C) pair: the forward
    reads prediction and target and writes the loss; the backward reads
    them and the cotangent and writes the prediction's gradient."""
    n = height * width * channels
    if kind == "forward":
        return n * LOSS_FWD_FLOPS, 8 * n + 4
    return n * LOSS_BWD_FLOPS, 12 * n + 4


def adam(floats: int, rows: int, groups: int) -> tuple:
    """(flops, bytes) of one update: each float's gradient, parameter and
    two moments read and the parameter and moments written (28 bytes), the
    mask's byte a row, each group's count read and written."""
    return ADAM_FLOPS * floats, 28 * floats + rows + 8 * groups
