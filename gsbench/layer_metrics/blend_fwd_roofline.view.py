"""The blend forward kernel's share of its bound in a viewer frame: the work
model's operations over the reference's contributing pairs, over the
kernel's device time by name."""

from gsbench.work.shares import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "blend_forward")
