"""The blend kernels' share of their bound in a train step, forward and
backward: the work model's operations over the reference's contributing
pairs, over the kernels' device time by name."""

from gsbench.work.shares import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "blend_forward", "blend_backward")
