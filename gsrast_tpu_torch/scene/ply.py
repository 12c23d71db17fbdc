"""Trained-scene .ply import and export.

Parses the vertex element of a trained 3DGS .ply by property name (robust to
SH-degree variants) into the raw-parameter `GaussianScene`; activations stay
explicit (`GaussianScene.activated`). `save_ply` writes the same layout back.
"""

from __future__ import annotations

import io
import re
from typing import Dict, List, Tuple

import numpy as np

from . import gaussians as G

_PLY_DTYPES = {
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
    "uchar": np.uint8, "uint8": np.uint8,
    "char": np.int8, "int8": np.int8,
    "ushort": np.uint16, "uint16": np.uint16,
    "short": np.int16, "int16": np.int16,
    "uint": np.uint32, "uint32": np.uint32,
    "int": np.int32, "int32": np.int32,
}
_HEADER_BYTES = 1 << 16  # a vertex header of a few hundred properties fits


def _parse_header(data: bytes) -> Tuple[int, List[Tuple[str, np.dtype]], int, str]:
    """Returns (vertex_count, [(prop_name, dtype)...], body_offset, format)."""
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError("not a PLY file: no end_header")
    body = data.find(b"\n", end) + 1
    header = data[:end].decode("ascii", errors="replace")
    lines = [ln.strip() for ln in header.splitlines() if ln.strip()]
    if not lines or lines[0] != "ply":
        raise ValueError("not a PLY file: missing magic")
    fmt = "binary_little_endian"
    count = None
    props: List[Tuple[str, np.dtype]] = []
    in_vertex = False
    for ln in lines[1:]:
        if ln.startswith("format"):
            fmt = ln.split()[1]
        elif ln.startswith("element"):
            _, name, cnt = ln.split()
            in_vertex = name == "vertex"
            if in_vertex:
                count = int(cnt)
        elif ln.startswith("property") and in_vertex:
            parts = ln.split()
            if parts[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((parts[2], np.dtype(_PLY_DTYPES[parts[1]])))
    if count is None:
        raise ValueError("no vertex element in PLY header")
    return count, props, body, fmt


def read_ply_raw(path_or_bytes) -> Dict[str, np.ndarray]:
    """Read a PLY vertex element into {property_name: (N,) array}.

    A binary little-endian file goes through the native codec
    (`scene/native.py`), which returns every column as float32; bytes, ascii
    and big-endian input are read here with numpy, each column in its own
    type."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            head = f.read(_HEADER_BYTES)
        if _parse_header(head)[3] == "binary_little_endian":
            from . import native

            return native.read_ply_columns(str(path_or_bytes))
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    count, props, body, fmt = _parse_header(data)
    if fmt in ("binary_little_endian", "binary_big_endian"):
        order = "<" if fmt == "binary_little_endian" else ">"
        rec = np.dtype([(n, d.newbyteorder(order)) for n, d in props])
        arr = np.frombuffer(data, dtype=rec, count=count, offset=body)
        return {n: np.ascontiguousarray(arr[n]).astype(d) for n, d in props}
    if fmt == "ascii":
        text = data[body:].decode("ascii")
        vals = np.loadtxt(io.StringIO(text), max_rows=count, ndmin=2)
        return {n: vals[:, i].astype(d) for i, (n, d) in enumerate(props)}
    raise ValueError(f"unsupported PLY format {fmt}")


def _sorted_numeric(names, prefix: str) -> List[str]:
    pat = re.compile(re.escape(prefix) + r"_(\d+)$")
    found = [(int(m.group(1)), n) for n in names if (m := pat.match(n))]
    return [n for _, n in sorted(found)]


def load_ply(path_or_bytes, device="cpu") -> G.GaussianScene:
    """Load a trained 3DGS .ply into a raw-parameter GaussianScene on
    `device`.

    The on-disk f_rest_0..44 are channel-major ([3, 15]: all rest coeffs of
    R, then G, then B) and are transposed into sh[:, 1:, :]; sh[:, 0, :] is
    (f_dc_0..2)."""
    raw = read_ply_raw(path_or_bytes)
    n = raw["x"].shape[0]
    means = np.stack([raw["x"], raw["y"], raw["z"]], axis=1).astype(np.float32)
    dc_names = _sorted_numeric(raw, "f_dc")
    rest_names = _sorted_numeric(raw, "f_rest")
    n_rest = len(rest_names)
    if n_rest % 3 != 0:
        raise ValueError(f"f_rest count {n_rest} not divisible by 3")
    k = 1 + n_rest // 3
    sh = np.zeros((n, k, 3), np.float32)
    for c, name in enumerate(dc_names):
        sh[:, 0, c] = raw[name]
    if n_rest:
        rest = np.stack([raw[nm] for nm in rest_names], axis=1).astype(np.float32)
        sh[:, 1:, :] = rest.reshape(n, 3, k - 1).transpose(0, 2, 1)
    log_scales = np.stack([raw[nm] for nm in _sorted_numeric(raw, "scale")],
                          axis=1).astype(np.float32)
    quats = np.stack([raw[nm] for nm in _sorted_numeric(raw, "rot")],
                     axis=1).astype(np.float32)
    return G.from_numpy(dict(means=means, log_scales=log_scales, quats=quats,
                             opacity_logits=raw["opacity"], sh=sh),
                        device=device)


def save_ply(scene: G.GaussianScene, path: str) -> None:
    """Write the live Gaussians of `scene` in the standard trained-scene
    .ply layout (the inverse of `load_ply`; raw parameters, normals zero)."""
    host = {f: getattr(scene, f).detach().cpu().numpy()
            for f in G.PARAM_FIELDS + ("mask",)}
    live = host.pop("mask")
    means, log_scales, quats, opacity, sh = (host[f][live]
                                             for f in G.PARAM_FIELDS)
    n, k, _ = sh.shape
    n_rest = (k - 1) * 3
    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(n_rest)]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    out = np.zeros(n, np.dtype([(nm, "<f4") for nm in names]))
    out["x"], out["y"], out["z"] = means.T
    for i in range(3):
        out[f"f_dc_{i}"] = sh[:, 0, i]
        out[f"scale_{i}"] = log_scales[:, i]
    rest = sh[:, 1:, :].transpose(0, 2, 1).reshape(n, n_rest)
    for i in range(n_rest):
        out[f"f_rest_{i}"] = rest[:, i]
    out["opacity"] = opacity
    for i in range(4):
        out[f"rot_{i}"] = quats[:, i]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {nm}" for nm in names]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(out.tobytes())
