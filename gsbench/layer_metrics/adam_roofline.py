"""The optimizer kernel's share of its bound: the bytes of one masked Adam
update of every parameter over its device time by name."""

from gsbench.work.shares import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "adam")
