"""Build and load the hand-written CUDA kernels of `csrc/`.

The sources compile with nvcc into one shared library with a plain C
interface, loaded through ctypes. The build runs at first use into
`_build/` next to this file, keyed by a hash of the sources and the flags,
so a fresh checkout builds once and later processes reuse the library.
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

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches per kernel since the last reset: each wrapper adds one where it
# launches its kernel, and nowhere else.
launch_counts = {"blend_forward": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


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
    for src in sources:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"libgsrast_kernels_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n"
                f"{log}")
        os.replace(tmp, path)  # atomic: a concurrent process never loads half
    lib = ctypes.CDLL(str(path))
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    fn = lib.gsrast_blend_forward
    fn.argtypes = [vp, i64, vp, i32, i32, i32, i32, f32, f32, f32, vp, vp, vp,
                   vp]
    fn.restype = ctypes.c_int
    return Library(lib=lib, path=path, build_seconds=seconds, build_log=log)
