"""Shares of the peak that the per-layer readers report, from a traced
window (`ctx['window']`, a `gsbench.trace.Window`) and the reference's work
over the traced steps (`ctx['work']`, per kernel group: flops, bytes and
summed bound)."""

from __future__ import annotations

from . import model

# Kernel group -> (the kernel names whose device time it takes, the one
# kernel counted once a call).
KERNELS = {
    "preprocess_forward": (("preprocess_forward_kernel",),
                           "preprocess_forward_kernel"),
    "preprocess_backward": (("preprocess_backward_kernel",),
                            "preprocess_backward_kernel"),
    "blend_forward": (("blend_forward_kernel",), "blend_forward_kernel"),
    "blend_backward": (("blend_backward_kernel",), "blend_backward_kernel"),
    "loss_forward": (("loss_forward_kernel", "loss_sum_kernel"),
                     "loss_forward_kernel"),
    "loss_backward": (("loss_backward_kernel",), "loss_backward_kernel"),
    "adam": (("adam_update_kernel",), "adam_update_kernel"),
}


def roofline_pct(ctx: dict, *groups: str):
    """The groups' bound over their device time, a call each, in percent:
    the summed bound per step over the summed device time per call (calls
    counted in the trace, so a launch the profiler missed does not count
    as time saved). None where a group left no trace."""
    steps = ctx["steps"]
    bound = time = 0.0
    for g in groups:
        names, counted = KERNELS[g]
        calls = ctx["window"].count(counted)
        if calls == 0 or g not in ctx["work"]:
            return None
        bound += ctx["work"][g]["bound_s"] / steps
        time += ctx["window"].seconds(*names) / calls
    return 100.0 * bound / time


def mfu_pct(ctx: dict):
    """The float32 operations of the traced steps (every kernel group of
    the work model) over the traced window at the float32 peak, percent."""
    flops = sum(w["flops"] for w in ctx["work"].values())
    return 100.0 * flops / (ctx["window_s"] * model.FP32_FLOPS)
