"""The preprocess kernels' share of their bound, forward and backward
over a traced step: the work model's bytes and operations over their device
time by kernel name."""

from gsbench.work.shares import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "preprocess_forward", "preprocess_backward")
