"""The scenes of the configurations (`gsbench/configs/<name>.json`, its
`scene` and `framing` objects) and the start of a train run, made from the
seed.

    {"kind": "random_cube", "n": 1000000, "sh_degree": 3, "extent": 1.0,
     "scale_range": [0.002, 0.008], "opacity_logit_range": [-1.0, 3.0],
     "sh_rest_sigma": 0.1}
        the reference benchmark's synthetic scene: means uniform in the
        cube [-extent, extent]^3, log-uniform anisotropic scales over
        `scale_range` x extent, uniform random rotations, opacity logits
        uniform in their range, SH DC uniform in [-1, 1) and the rest
        bands normal with `sh_rest_sigma`; drawn on the device by a
        `torch.Generator` seeded with the run's seed, in a few large calls.
    {"kind": "ply", "file": "tests/fixtures/trained_116k.ply",
     "sha256": "..."}
        a trained 3DGS .ply (binary little-endian), read as it is; the
        file's hash is checked, so a changed file stops the run.

Framing: {"kind": "look_at", "eye": [...], "target": [...], "fov_x": rad,
"fov_y": rad} or {"kind": "bbox", "fov_y_deg": 45}, which looks at the
centre of the live splats' bounding box from one diagonal away, as the
program's viewer frames a scene.
"""

from __future__ import annotations

import hashlib
import math
import os

import numpy as np
import torch

from . import ROOT

FIELDS = ("means", "log_scales", "quats", "opacity_logits", "sh")


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A device generator for `seed` (any whole number) and a stream."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 7919 + stream) % (1 << 63))
    return g


def random_cube(spec: dict, gen: torch.Generator, device) -> dict:
    n, e = int(spec["n"]), float(spec["extent"])
    k = (int(spec["sh_degree"]) + 1) ** 2

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    lo, hi = (math.log(s * e) for s in spec["scale_range"])
    quats = torch.randn((n, 4), generator=gen, device=device)
    sh = torch.zeros((n, k, 3), device=device)
    sh[:, 0] = uniform((n, 3), -1.0, 1.0)
    if k > 1:
        sh[:, 1:] = float(spec["sh_rest_sigma"]) * torch.randn(
            (n, k - 1, 3), generator=gen, device=device)
    return {"means": uniform((n, 3), -e, e),
            "log_scales": uniform((n, 3), lo, hi),
            "quats": quats / torch.linalg.vector_norm(quats, dim=-1,
                                                      keepdim=True),
            "opacity_logits": uniform((n,), *spec["opacity_logit_range"]),
            "sh": sh, "mask": torch.ones(n, dtype=torch.bool, device=device)}


def read_ply(spec: dict, device) -> dict:
    path = os.path.join(ROOT, spec["file"])
    with open(path, "rb") as f:
        data = f.read()
    digest = hashlib.sha256(data).hexdigest()
    if digest != spec["sha256"]:
        raise RuntimeError(f"{spec['file']} has sha256 {digest}, not the "
                           f"configuration's {spec['sha256']}")
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    if "format binary_little_endian 1.0" not in header:
        raise ValueError(f"{spec['file']}: not a binary little-endian .ply")
    n = next(int(h.split()[2]) for h in header
             if h.startswith("element vertex"))
    names = [h.split()[2] for h in header if h.startswith("property float")]
    if len(names) != sum(h.startswith("property") for h in header):
        raise ValueError(f"{spec['file']}: only float properties are read")
    rows = np.frombuffer(data, "<f4", n * len(names), end).reshape(n, -1)
    col = {name: rows[:, i] for i, name in enumerate(names)}

    def stack(prefix):
        keys = sorted((k for k in col if k.startswith(prefix)),
                      key=lambda k: int(k.rsplit("_", 1)[1]))
        return np.stack([col[k] for k in keys], axis=1)

    rest = stack("f_rest_") if "f_rest_0" in col else np.zeros((n, 0))
    kr = rest.shape[1] // 3
    sh = np.concatenate([stack("f_dc_")[:, None, :],
                         rest.reshape(n, 3, kr).transpose(0, 2, 1)], axis=1)
    arrays = {"means": np.stack([col["x"], col["y"], col["z"]], axis=1),
              "log_scales": stack("scale_"), "quats": stack("rot_"),
              "opacity_logits": col["opacity"], "sh": sh}
    out = {k: torch.tensor(np.ascontiguousarray(v, np.float32),
                           device=device) for k, v in arrays.items()}
    out["mask"] = torch.ones(n, dtype=torch.bool, device=device)
    return out


def make(spec: dict, seed: int, device) -> dict:
    """The raw parameters (float32) and the live mask of a scene."""
    if spec["kind"] == "random_cube":
        return random_cube(spec, generator(seed, device), device)
    if spec["kind"] == "ply":
        return read_ply(spec, device)
    raise ValueError(f"unknown scene kind {spec['kind']!r}")


def extent(params: dict) -> float:
    """The length of the live splats' bounding-box diagonal."""
    means = params["means"][params["mask"]]
    return float(torch.linalg.vector_norm(means.amax(0) - means.amin(0)))


def perturbed(params: dict, spec: dict, seed: int, device) -> dict:
    """A train run's start (the configuration's `train.start`): means moved
    by N(0, (means_sigma x extent)^2), opacity logits shifted."""
    gen = generator(seed, device, stream=1)
    out = {k: v.clone() for k, v in params.items()}
    sigma = float(spec["means_sigma"]) * extent(params)
    out["means"] += sigma * torch.randn(out["means"].shape, generator=gen,
                                        device=device)
    out["opacity_logits"] += float(spec["opacity_logit_shift"])
    return out


def framing(spec: dict, params: dict, width: int, height: int) -> dict:
    """The framing camera: target, distance, fields of view and depth
    range."""
    if spec["kind"] == "look_at":
        eye = np.asarray(spec["eye"], np.float64)
        target = np.asarray(spec["target"], np.float64)
        dist = float(np.linalg.norm(eye - target))
        return {"target": target, "distance": dist, "fov_x": spec["fov_x"],
                "fov_y": spec["fov_y"], "znear": 0.01, "zfar": 100.0}
    if spec["kind"] == "bbox":
        means = params["means"][params["mask"]]
        lo, hi = (x.double().cpu().numpy() for x in (means.amin(0),
                                                     means.amax(0)))
        span = max(float(np.linalg.norm(hi - lo)), 1e-3)
        fov_y = math.radians(spec["fov_y_deg"])
        fov_x = 2.0 * math.atan(math.tan(fov_y / 2.0) * width / height)
        return {"target": 0.5 * (lo + hi), "distance": span, "fov_x": fov_x,
                "fov_y": fov_y, "znear": 0.01, "zfar": max(100.0, 4.0 * span)}
    raise ValueError(f"unknown framing kind {spec['kind']!r}")
