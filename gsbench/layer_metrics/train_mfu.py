"""The whole train step's share of the float32 peak: the operations the
step needs (preprocess, blend, loss and Adam, by the work model over the
reference's counts) over the traced window at 67 TFLOP/s."""

from gsbench.work.shares import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
