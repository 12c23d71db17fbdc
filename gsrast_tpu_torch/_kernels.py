"""Build and load the hand-written CUDA kernels of `csrc/`.

Each source compiles with its own nvcc process, all started together, and
the objects link into one shared library with a plain C interface, loaded
through ctypes. The build runs at first use into `_build/` next to this
file, keyed by a hash of the sources and the flags, so a fresh checkout
builds once and later processes reuse the library.
Nothing here runs at import time: machines without nvcc import the package
and use the plain PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch

from .camera import CAMERA_TENSORS

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# Launches per kernel since the last reset: each wrapper adds one where it
# launches its kernel, and nowhere else.
launch_counts = {"tile_order": 0, "blend_forward": 0, "blend_backward": 0,
                 "bisect_a": 0, "bisect_b": 0, "bisect_c": 0, "bisect_d": 0,
                 "preprocess_forward": 0, "preprocess_backward": 0,
                 "loss_forward": 0, "loss_backward": 0, "adam": 0,
                 "ellipsoids": 0, "plan_tiers": 0}


# Runs per kernel inside CUDA graph replays since the last reset: a replay
# calls no wrapper, so `replay` adds here the launches its capture recorded.
# (A capture calls the wrappers, which count, but only records the kernels.)
replayed_counts = dict.fromkeys(launch_counts, 0)


# Zero int32 counters that a kernel keeps per device between launches (its
# last block takes them back to zero: tickets, counts of the blocks done), by
# kernel and device. A launch finds them zero only if no other launch of the
# same kernel runs on the device at the same time.
_DEVICE_COUNTERS: dict = {}


def device_counters(kernel: str, device: torch.device,
                    n: int = 1) -> torch.Tensor:
    """Kernel `kernel`'s n counters on `device`, made (zero) at its first
    launch there: outside a CUDA graph's capture, as every capture here
    follows an eager warm-up."""
    key = (kernel, device.type, device.index)
    if key not in _DEVICE_COUNTERS:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"launch the {kernel} kernel on the device once "
                               f"before capturing it in a CUDA graph")
        _DEVICE_COUNTERS[key] = torch.zeros(n, dtype=torch.int32,
                                            device=device)
    return _DEVICE_COUNTERS[key]


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = replayed_counts[name] = 0


def uses_kernel(backend: str, device: torch.device) -> bool:
    """The dispatch rule of every kernel: the kernel runs for CUDA tensors
    under backend 'cuda', and its plain version otherwise (the 'torch',
    'autograd' and 'dense' oracles never reach a kernel)."""
    return backend == "cuda" and device.type == "cuda"


def replay(graph, launches: dict) -> None:
    """graph.replay(), adding the `launches` its capture recorded (per
    kernel, as `capture` returns them) to `replayed_counts`."""
    graph.replay()
    for name, count in launches.items():
        replayed_counts[name] += count


def on_side_stream(fn: Callable, device):
    """fn() on a side stream of `device`, ordered after and before the
    current stream's work: the warm-up of PyTorch's whole-network capture
    recipe (every kernel has loaded and every allocation has a block
    before the capture). Returns fn's output."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn()
    current.wait_stream(side)
    return out


def capture(fn: Callable, what: str) -> tuple:
    """Capture fn() into a CUDA graph: returns (graph, fn's output, the
    launches per kernel of `launch_counts` that the capture recorded). The
    output's tensors are the graph's, rewritten by every replay. A failed
    capture raises, chained to fn's error, naming `what`."""
    before = dict(launch_counts)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn()
    except RuntimeError as err:
        raise RuntimeError(
            f"capturing {what} in a CUDA graph failed: {err}") from err
    return graph, out, {k: launch_counts[k] - before[k] for k in before}


@dataclasses.dataclass
class GraphSlot:
    """One image shape's static inputs (a camera and further tensors, which
    each call copies its own into), its graph, the graph's output and the
    launches per kernel its capture recorded."""

    camera: object
    inputs: tuple
    graph: Optional[torch.cuda.CUDAGraph] = None
    out: object = None
    launches: Optional[dict] = None

    def load(self, camera, inputs: tuple) -> None:
        for name in CAMERA_TENSORS:
            getattr(self.camera, name).copy_(getattr(camera, name))
        for static, given in zip(self.inputs, inputs):
            static.copy_(given)


class ShapeGraphs:
    """A function of a camera (and further tensors) captured once per image
    shape (height, width) into a CUDA graph and replayed: the counterpart of
    the reference's `jax.jit`, which compiles once and dispatches one
    program a call.

    `run(fn, camera, *inputs)` returns fn(camera, *inputs) computed on the
    shape's static inputs, into which each call copies the given ones, so
    views visited round robin, each with its own intrinsics, share one
    graph. The first call of a shape runs fn eagerly on a side stream
    (`on_side_stream`: every kernel loads and every allocation has a block
    before the capture) and returns its output; the second captures fn
    and replays it once, so fn runs once a call; every later call is one
    `replay()`. From the second call on, the output is the graph's own,
    rewritten by the next replay. A failed capture raises, chained to fn's
    error and naming `what`; nothing falls back to eager calls.

    `captures` and `replays` count graphs captured and replays run;
    `captured`, per kernel of `launch_counts`, the launches the captures
    recorded. A replay launches no wrapper, so it adds nothing to
    `launch_counts`, and its capture's launches to `replayed_counts`."""

    def __init__(self, what: str):
        self.what = what
        self.slots = {}  # (height, width) -> GraphSlot
        self.captures = self.replays = 0
        self.captured = dict.fromkeys(launch_counts, 0)

    def replays_next(self, camera) -> bool:
        """Whether a call with `camera` is a replay of a captured graph."""
        slot = self.slots.get((camera.height, camera.width))
        return slot is not None and slot.graph is not None

    def run(self, fn: Callable, camera, *inputs):
        shape = (camera.height, camera.width)
        slot = self.slots.get(shape)
        if slot is None:
            slot = self.slots[shape] = GraphSlot(
                camera.replace(**{name: getattr(camera, name).clone()
                                  for name in CAMERA_TENSORS}),
                tuple(x.clone() for x in inputs))
            return on_side_stream(lambda: fn(slot.camera, *slot.inputs),
                                  camera.device)
        slot.load(camera, inputs)
        if slot.graph is None:
            slot.graph, slot.out, slot.launches = capture(
                lambda: fn(slot.camera, *slot.inputs),
                f"{self.what} ({shape[0]} x {shape[1]})")
            for name, count in slot.launches.items():
                self.captured[name] += count
            self.captures += 1
        replay(slot.graph, slot.launches)
        self.replays += 1
        return slot.out


class Launch(NamedTuple):
    """One kernel launch made ready: the C function, its arguments (the
    inputs' and outputs' pointers and the current stream), and the outputs,
    which are written by each `fn(*args)`. It holds its inputs, so that
    their memory lives as long as it."""

    fn: Callable
    args: tuple
    out: object
    held: dict
    device: torch.device


def run(launch: Launch, name: str) -> None:
    """Launch on its device, count it under `name`, and raise if CUDA
    refused it."""
    with torch.cuda.device(launch.device):
        code = launch.fn(*launch.args)
    launch_counts[name] += 1
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")


@dataclasses.dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an earlier build was reused
    build_log: str        # nvcc's output, with ptxas register/spill lines


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([Path(home) / "bin" / "nvcc"] if home else []) + [
        Path("/usr/local/cuda/bin/nvcc")]
    for cand in candidates:
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def set_preprocess_argtypes(lib) -> None:
    """The preprocess kernels' entry points' argument types (also for a
    build of `csrc/preprocess.cu` alone)."""
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    fn = lib.gsrast_preprocess_forward
    fn.argtypes = [*[vp] * 8, *[i32] * 9, *[f32] * 5, *[vp] * 8]
    fn.restype = ctypes.c_int
    fn = lib.gsrast_preprocess_backward
    fn.argtypes = [*[vp] * 6, *[i32] * 5, *[f32] * 3, vp, i64, i64, vp, i64,
                   vp, i64, i64, vp, i64, i64, vp, i64, *[vp] * 6]
    fn.restype = ctypes.c_int
    fn = lib.gsrast_preprocess_forward_occupancy
    fn.argtypes = [*[i32] * 3, *[vp] * 7]
    fn.restype = ctypes.c_int
    fn = lib.gsrast_preprocess_backward_occupancy
    fn.argtypes = [i32, i32, *[vp] * 6]
    fn.restype = ctypes.c_int


# The inputs of the ellipsoid kernel's entry points (`viz/ellipsoids.py::
# frame_args`): the activated Gaussians' pointers and the SH row's floats,
# the mask, the camera's four pointers, then N, height, width.
ELLIPSOID_INPUT_ARGTYPES = [*[ctypes.c_void_p] * 5, ctypes.c_int,
                            *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 3]


def set_ellipsoid_argtypes(lib) -> None:
    """The ellipsoid kernel's entry points' argument types (also for a
    build of `csrc/ellipsoids.cu` alone)."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gsrast_ellipsoids.argtypes = [*ELLIPSOID_INPUT_ARGTYPES, *[vp] * 4]
    lib.gsrast_ellipsoids_terms.argtypes = [*ELLIPSOID_INPUT_ARGTYPES, vp, vp]
    lib.gsrast_ellipsoids_scratch.argtypes = [
        i32, i32, i32, ctypes.POINTER(ctypes.c_longlong)]
    lib.gsrast_ellipsoids_occupancy.argtypes = [*[i32] * 4, *[vp] * 6]
    for name in ("gsrast_ellipsoids", "gsrast_ellipsoids_terms",
                 "gsrast_ellipsoids_scratch", "gsrast_ellipsoids_occupancy"):
        getattr(lib, name).restype = i32


def set_order_argtypes(lib) -> None:
    """The tile order's entry points' argument types (also for a build of
    `csrc/tile_order.cu` alone)."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gsrast_tile_order.argtypes = [vp, i32, vp, vp, vp, vp]
    lib.gsrast_tile_order.restype = i32
    lib.gsrast_tile_order_table.argtypes = [i32]
    lib.gsrast_tile_order_table.restype = ctypes.c_longlong


def set_plan_argtypes(lib) -> None:
    """The tile plan's entry points' argument types (also for a build of
    `csrc/plan.cu` alone; `ops/binning.py::plan_tiers_launch` calls them)."""
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gsrast_plan_shape.argtypes = [ctypes.c_longlong, i32, vp]
    lib.gsrast_plan_shape.restype = None
    lib.gsrast_plan_rank.argtypes = [vp] * 8
    lib.gsrast_plan_slots.argtypes = [vp, vp, f32, *[vp] * 11,
                                      ctypes.c_longlong, vp]
    lib.gsrast_plan_cull.argtypes = [vp, vp, f32, vp, vp]
    for name in ("gsrast_plan_rank", "gsrast_plan_slots", "gsrast_plan_cull"):
        getattr(lib, name).restype = i32


@functools.cache
def load() -> Library:
    """Build (if needed) and load the kernel library. Raises if nvcc fails."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):  # the headers (*.cuh) too
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"libgsrast_kernels_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]  # one nvcc per source, all at once
        logs = [(cmd, proc.communicate()[0], proc.returncode)
                for cmd, proc in zip(cmds, procs)]
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        if all(code == 0 for _, _, code in logs):
            proc = subprocess.run(link, capture_output=True, text=True)
            logs.append((link, proc.stdout + proc.stderr, proc.returncode))
        for obj in objs:
            obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        log = "".join(out for _, out, _ in logs)
        for cmd, out, code in logs:
            if code != 0:
                raise RuntimeError(f"nvcc failed with code {code}:\n"
                                   f"{' '.join(cmd)}\n{out}")
        os.replace(tmp, path)  # atomic: a concurrent process never loads half
    lib = ctypes.CDLL(str(path))
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    set_order_argtypes(lib)
    fn = lib.gsrast_blend_forward
    fn.argtypes = [vp, i64, vp, vp, *[i32] * 6, f32, f32, f32, vp, vp, vp, vp]
    fn.restype = ctypes.c_int
    fn = lib.gsrast_blend_backward
    fn.argtypes = [vp, i64, vp, vp, *[i32] * 6, f32, f32, *[vp] * 6]
    fn.restype = ctypes.c_int
    for name in ("a", "b"):
        fn = getattr(lib, f"gsrast_bisect_{name}")
        fn.argtypes = [vp, i32, vp, vp, vp]
        fn.restype = ctypes.c_int
    fn = lib.gsrast_bisect_c
    fn.argtypes = [vp, i32, vp, vp, vp, vp]
    fn.restype = ctypes.c_int
    fn = lib.gsrast_bisect_d
    fn.argtypes = [vp, i32, vp, vp, vp, vp, vp, vp, vp]
    fn.restype = ctypes.c_int
    set_preprocess_argtypes(lib)
    fn = lib.gsrast_loss_partials
    fn.argtypes = [i32, i32, i32]
    fn.restype = ctypes.c_int
    fn = lib.gsrast_loss_occupancy
    fn.argtypes = [*[i32] * 4, *[vp] * 8]
    fn.restype = ctypes.c_int
    fn = lib.gsrast_loss_forward
    fn.argtypes = [vp, *[i64] * 3, vp, *[i64] * 3, *[i32] * 3, vp, f32, f32,
                   vp, vp, vp]
    fn.restype = ctypes.c_int
    fn = lib.gsrast_loss_backward
    fn.argtypes = [vp, *[i64] * 3, vp, *[i64] * 3, *[i32] * 3, vp, f32, f32,
                   vp, vp, *[i64] * 3, vp]
    fn.restype = ctypes.c_int
    fn = lib.gsrast_adam_update
    fn.argtypes = [i32, *[vp] * 5, f32, vp, vp]
    fn.restype = ctypes.c_int
    fn = lib.gsrast_adam_occupancy
    fn.argtypes = [vp] * 5
    fn.restype = ctypes.c_int
    set_ellipsoid_argtypes(lib)
    set_plan_argtypes(lib)
    return Library(lib=lib, path=path, build_seconds=seconds, build_log=log)
