"""The loss kernels' share of their bound, forward (with its sum) and
backward: operations of the L1 + D-SSIM loss over an image, over their
device time by name."""

from gsbench.work.shares import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "loss_forward", "loss_backward")
