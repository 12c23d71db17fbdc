"""ctypes binding of the native PLY codec (`native/plyio.cpp` at the root of
the repository): one pass that de-interleaves a binary little-endian vertex
element into float32 columns, and its writer.

The library builds at first use with `g++ -O3 -fPIC -shared` into `_build/`
next to the package, keyed by a hash of the source and the flags; the
source directory is never written to. A failed build or load raises with
the compiler's or the loader's message: nothing falls back quietly.
`scene/ply.py::read_ply_raw` sends binary little-endian files here and reads
the other encodings with numpy.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "plyio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared")
_NAMES_CAP = 1 << 16  # bytes for the '\n'-joined property names


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the codec. Raises RuntimeError if g++ or
    the loader fails."""
    if not SOURCE.exists():
        raise RuntimeError(f"native PLY codec source not found: {SOURCE}")
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"libgsply_{digest}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except OSError as exc:
            raise RuntimeError(f"{' '.join(cmd)}: {exc}") from exc
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent process never loads half
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        raise RuntimeError(f"cannot load {path}: {exc}") from exc
    f32pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
    lib.gsply_header.restype = ctypes.c_long
    lib.gsply_header.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_long]
    lib.gsply_read_f32.restype = ctypes.c_int
    lib.gsply_read_f32.argtypes = [ctypes.c_char_p, f32pp, ctypes.c_int]
    lib.gsply_write_f32.restype = ctypes.c_int
    lib.gsply_write_f32.argtypes = [ctypes.c_char_p, ctypes.c_char_p, f32pp,
                                    ctypes.c_int, ctypes.c_long]
    return lib


def _pointers(cols):
    return (ctypes.POINTER(ctypes.c_float) * len(cols))(
        *[c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for c in cols])


def read_ply_columns(path: str) -> Dict[str, np.ndarray]:
    """{property: float32 (N,)} of a binary little-endian PLY's vertex
    element, in header order. Raises ValueError on a file the codec does
    not read (ascii, big-endian, list properties, short body)."""
    lib = load()
    names_buf = ctypes.create_string_buffer(_NAMES_CAP)
    count = lib.gsply_header(path.encode(), names_buf, _NAMES_CAP)
    if count < 0:
        raise ValueError(f"{path}: the native PLY reader cannot parse the "
                         f"header (code {count})")
    names = names_buf.value.decode().split("\n")[:-1]
    cols = [np.empty(count, np.float32) for _ in names]
    rc = lib.gsply_read_f32(path.encode(), _pointers(cols), len(cols))
    if rc != 0:
        raise ValueError(f"{path}: the native PLY reader failed (code {rc}: "
                         "2 not binary little-endian, 4 short body)")
    return dict(zip(names, cols))


def write_ply_columns(path: str, columns: Dict[str, np.ndarray]) -> None:
    """Write float32 columns as a binary little-endian PLY vertex element.
    Raises OSError if the file cannot be written."""
    lib = load()
    names = list(columns)
    cols = [np.ascontiguousarray(columns[n], np.float32) for n in names]
    n = len(cols[0]) if cols else 0
    if any(len(c) != n for c in cols):
        raise ValueError("columns differ in length")
    rc = lib.gsply_write_f32(path.encode(), "\n".join(names).encode(),
                             _pointers(cols), len(cols), n)
    if rc != 0:
        raise OSError(f"{path}: the native PLY writer failed (code {rc})")
