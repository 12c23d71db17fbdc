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
from typing import Callable, NamedTuple

import torch

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
                 "loss_forward": 0, "loss_backward": 0, "adam": 0}


# Runs per kernel inside CUDA graph replays since the last reset: a replay
# calls no wrapper, so `replay` adds here the launches its capture recorded.
# (A capture calls the wrappers, which count, but only records the kernels.)
replayed_counts = dict.fromkeys(launch_counts, 0)


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = replayed_counts[name] = 0


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
    fn = lib.gsrast_tile_order
    fn.argtypes = [vp, i32, vp, vp]
    fn.restype = ctypes.c_int
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
    fn = lib.gsrast_preprocess_forward
    fn.argtypes = [*[vp] * 8, *[i32] * 9, *[f32] * 5, *[vp] * 8]
    fn.restype = ctypes.c_int
    fn = lib.gsrast_preprocess_backward
    fn.argtypes = [*[vp] * 6, *[i32] * 5, *[f32] * 3, vp, i64, i64, vp, i64,
                   vp, i64, i64, vp, i64, i64, vp, i64, *[vp] * 6]
    fn.restype = ctypes.c_int
    fn = lib.gsrast_preprocess_backward_occupancy
    fn.argtypes = [i32, i32, *[vp] * 6]
    fn.restype = ctypes.c_int
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
    fn.argtypes = [i32, *[vp] * 5, f32, vp]
    fn.restype = ctypes.c_int
    fn = lib.gsrast_adam_occupancy
    fn.argtypes = [vp] * 5
    fn.restype = ctypes.c_int
    return Library(lib=lib, path=path, build_seconds=seconds, build_log=log)
