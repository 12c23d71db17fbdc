"""Tracing of the program: layer spans, device marks, tile-plan counters,
a profiler trace and the memory report.

  * `span(stage, layer, device)`: the span `<layer>.<stage>` of a layer's
    forward work; `backward_end` / `backward_start`: the span
    `<name>.bwd` of its backward, bounded at the layer's inputs and
    outputs;
  * `count_plan`, `counters`: the tile plan's counters;
  * `trace(logdir)`: a `torch.profiler` trace of a block (host and, where a
    card is present, device activity), written as a Chrome trace to
    `<logdir>/trace.json`;
  * `device_memory_report`: allocated, peak and reserved bytes per card.

One switch, `GSRAST_TORCH_TRACE=1` in the environment when this module is
first imported (`tracing()`). Off, the default, a span is a profiler range
while a profiler runs and nothing otherwise, and nothing here launches,
captures or inserts anything. On, a span on a CUDA device also enqueues a
device mark on the current stream at its start, before its host range
opens, and at its end, after the range closes: one launch of
`csrc/trace.cu`'s `gsrast_span_mark<id, edge>`, id the span's index in
`SPANS`, edge `START` or `END`. Work captured in a CUDA graph between two
marks carries its span into every replay, which runs no host range. A
layer's backward is bounded by identity autograd nodes at its outputs and
inputs, inserted only while tracing and grad are on, whose backward
launches the marks of `<name>.bwd` and opens and closes its host range.
And each render adds its tile plan to the device's counters (`COUNTERS`)
by plain tensor adds on the device, inside its plan's span and inside a
graph where captured.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, List

import torch

_TRACING = os.environ.get("GSRAST_TORCH_TRACE") == "1"

# Every span, by its mark's id (the index here; `csrc/trace.cu` takes at
# most its `kSpans`). The `graph.*` spans are `_kernels.
# ShapeGraphs.run`'s (`graph.load` the copies into a graph's static inputs,
# the only one with device marks); the `.bwd` spans are backward spans.
SPANS = (
    "graph.load", "graph.capture", "graph.eager", "graph.replay",
    "scene.activate", "render.prep", "render.binning", "render.pack",
    "render.blend", "render.untile", "train.loss", "train.backward",
    "train.adam", "train.stats",
    "train.loss.bwd", "render.untile.bwd", "render.blend.bwd",
    "render.pack.bwd", "render.prep.bwd", "scene.activate.bwd",
)
SPAN_IDS = {name: i for i, name in enumerate(SPANS)}
START, END = 0, 1
# The counters a device keeps (int64): live slots (the plan's
# intersections), granted slots (its static slot count) and dropped
# (splat, tile) pairs (`overflow_tile_cap`, and the legacy binning's
# `overflow_capacity`), summed over every render since tracing began.
COUNTERS = ("plan.live", "plan.granted", "plan.dropped")

_local = threading.local()


def tracing() -> bool:
    """Whether GSRAST_TORCH_TRACE=1 turned tracing on."""
    return _TRACING


def _profiling() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


def _backward_ranges() -> Dict[str, list]:
    """This thread's open host ranges of backward spans, by name."""
    return _local.__dict__.setdefault("backward", {})


def _block(device: torch.device) -> torch.Tensor:
    """The device's counters (`_kernels.device_counters`)."""
    from .. import _kernels

    return _kernels.device_counters("trace", device, len(COUNTERS),
                                    torch.int64)


def _mark(name: str, edge: int, device: torch.device) -> None:
    """Launch the mark of span `name` on the device's current stream. The
    mark is a launch of its own on the host too: a span of eager work pays
    for two (a few microseconds each), a captured one only at its
    capture."""
    from .. import _kernels

    args = (SPAN_IDS[name], edge,
            torch.cuda.current_stream(device).cuda_stream)
    fn = _kernels.load().lib.gsrast_trace_mark
    if device.index in (None, torch.cuda.current_device()):
        code = fn(*args)
    else:
        with torch.cuda.device(device):
            code = fn(*args)
    _kernels.launch_counts["trace_mark"] += 1
    if code != 0:
        raise RuntimeError(f"trace_mark kernel launch failed: CUDA error "
                           f"{code}")


class _Marked:
    """A span with device marks (`span`): the start mark, the host range
    while a profiler runs, the end mark."""

    def __init__(self, name: str, device: torch.device):
        self.name, self.device, self.range = name, device, None

    def __enter__(self):
        _mark(self.name, START, self.device)
        if _profiling():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        if exc[0] is None:
            _mark(self.name, END, self.device)


def span(stage: str, layer: str = "render", device=None):
    """The span `<layer>.<stage>` around a block: with tracing on and a
    CUDA `device`, its device marks and, while a profiler runs, its host
    range; otherwise the host range while a profiler runs and nothing
    else, so that an unprofiled, untraced call pays no dispatcher calls."""
    name = f"{layer}.{stage}"
    if _TRACING and device is not None and device.type == "cuda":
        return _Marked(name, device)
    if _profiling():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def count_plan(live: torch.Tensor, granted: int, *dropped: torch.Tensor):
    """Add one render's tile plan to its device's counters where tracing is
    on (nothing otherwise): live slots (an int32 0-d tensor), the granted
    slot count and the dropped pairs (one or two int32 0-d tensors), by
    plain tensor adds on the stream, so that a CUDA graph captures them
    with the render."""
    if not _TRACING:
        return
    block = _block(live.device)
    with torch.no_grad():
        block[0] += live
        block[1] += int(granted)
        for d in dropped:
            block[2] += d


def counters(reset: bool = False) -> Dict[str, int]:
    """The counters (`COUNTERS`) summed over every device since tracing
    began or the last reset, as host ints: one copy a device, which waits
    for the work queued before it, so call it where the caller syncs
    already. `reset` zeroes them after the read. All 0 without tracing."""
    from .. import _kernels

    total = [0] * len(COUNTERS)
    for (kernel, *_), block in _kernels._DEVICE_COUNTERS.items():
        if kernel != "trace":
            continue
        for i, v in enumerate(block.tolist()):
            total[i] += v
        if reset:
            block.zero_()
    return dict(zip(COUNTERS, total))


class _Boundary(torch.autograd.Function):
    """The identity on tensors, whose backward opens (`START`) or closes
    (`END`) the backward span `name`: a layer's outputs pass through a
    START node, its inputs through an END node, so the layer's backward
    runs between the two."""

    @staticmethod
    def forward(ctx, name, edge, *tensors):
        ctx.name, ctx.edge, ctx.device = name, edge, tensors[0].device
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        on_card = ctx.device.type == "cuda"
        ranges = _backward_ranges()
        if ctx.edge == START:
            if on_card:
                _mark(ctx.name, START, ctx.device)
            if _profiling():
                rf = torch.profiler.record_function(ctx.name)
                rf.__enter__()
                ranges.setdefault(ctx.name, []).append(rf)
        else:
            if ranges.get(ctx.name):
                ranges[ctx.name].pop().__exit__(None, None, None)
            if on_card:
                _mark(ctx.name, END, ctx.device)
        return (None, None, *grads)


def _bound(name: str, edge: int, tensors: tuple):
    if (_TRACING and torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        tensors = _Boundary.apply(name, edge, *tensors)
    return tensors[0] if len(tensors) == 1 else tuple(tensors)


def backward_start(layer: str, *tensors: torch.Tensor):
    """`tensors`, a layer's differentiable outputs, as they are, or, with
    tracing and grad on, through a node whose backward starts the span
    `<layer>.bwd`. One tensor for one, else a tuple."""
    return _bound(f"{layer}.bwd", START, tensors)


def backward_end(layer: str, *tensors: torch.Tensor):
    """`tensors`, a layer's differentiable inputs, as `backward_start` has
    them, through a node whose backward ends the span `<layer>.bwd`."""
    return _bound(f"{layer}.bwd", END, tensors)


@contextlib.contextmanager
def trace(logdir: str = "gsrast_trace"):
    """Profile the block; yields the `torch.profiler.profile` (for
    `key_averages()`) and writes `<logdir>/trace.json` at its end."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_report() -> List[Dict]:
    """Per CUDA device: the caching allocator's allocated bytes now and at
    peak, its reserved bytes, and the device's total memory. Without a
    card, one entry for the CPU."""
    if not torch.cuda.is_available():
        return [{"device": "cpu"}]
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "name": torch.cuda.get_device_name(i),
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    return out
