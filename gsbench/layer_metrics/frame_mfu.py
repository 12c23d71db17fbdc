"""The whole viewer frame's share of the float32 peak: the operations the
frame needs (preprocess and blend forward, by the work model over the
reference's counts) over the traced window at 67 TFLOP/s."""

from gsbench.work.shares import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
