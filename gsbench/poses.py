"""The camera poses of a traffic mix: one general generator of the views
that a train loop visits and the path that a viewer follows, read from the
`poses` object of a traffic file (`gsbench/traffic/<name>.json`).

Every pose looks at the configuration's framing target from the framing
distance scaled by a dolly factor, at an azimuth about the vertical axis
and an elevation above the horizon (the scenes are Y-down, as trained 3DGS
scenes are). The set of poses is fixed by the traffic file and the
configuration; the seed only chooses the order in which they are used, so
every seed asks the same work of the program (of a drawn scene, work of
the same distribution).

    {"kind": "views", "count": 64, "elevation_deg": [10, 40],
     "dolly": [0.9, 1.1]}
        `count` views on a golden-angle spiral: azimuths spread over the
        circle, elevations and dollies spread over their ranges.
    {"kind": "path", "count": 720, "step_deg": 0.5, "dolly": [0.7, 1.3],
     "dolly_cycles": 2, "elevation_deg": [5, 35], "elevation_cycles": 1}
        a closed orbit of `count` poses, `step_deg` of azimuth apart, with
        the dolly and the elevation swept sinusoidally over their ranges a
        whole number of times a lap.
"""

from __future__ import annotations

import math

import numpy as np

GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0
UP = np.array([0.0, -1.0, 0.0], np.float32)


def look_at(eye, target) -> np.ndarray:
    """The (4, 4) float32 world-to-camera matrix looking from `eye` at
    `target`: +z into the screen, +y down the image, the world's -Y up."""
    eye, target = (np.asarray(v, np.float32) for v in (eye, target))
    fwd = target - eye
    fwd = fwd / np.float32(np.linalg.norm(fwd) + 1e-12)
    right = np.cross(fwd, UP).astype(np.float32)
    right = right / np.float32(np.linalg.norm(right) + 1e-12)
    down = np.cross(fwd, right).astype(np.float32)
    rot = np.stack([right, down, fwd]).astype(np.float32)
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = rot
    view[:3, 3] = -(rot @ eye)
    return view


def orbit_eye(target, distance: float, azimuth: float,
              elevation: float) -> np.ndarray:
    """A point `distance` from `target`; azimuth 0 and elevation 0 is the
    framing side, -z of the target."""
    ce = math.cos(elevation)
    return np.asarray(target, np.float64) + distance * np.array(
        [math.sin(azimuth) * ce, -math.sin(elevation),
         -math.cos(azimuth) * ce])


def _spread(lo_hi, u: float) -> float:
    lo, hi = lo_hi
    return lo + (hi - lo) * u


def pose_list(spec: dict, target, distance: float) -> list:
    """The (4, 4) view matrices of a `poses` object, in its own order."""
    views = []
    n = int(spec["count"])
    for i in range(n):
        if spec["kind"] == "views":
            azimuth = 2.0 * math.pi * i / n
            elevation = _spread(spec["elevation_deg"], (i * GOLDEN) % 1.0)
            dolly = _spread(spec["dolly"], (i * GOLDEN * GOLDEN) % 1.0)
        elif spec["kind"] == "path":
            azimuth = math.radians(spec["step_deg"] * i)
            turn = 2.0 * math.pi * i / n

            def sweep(key, cycles):
                u = 0.5 - 0.5 * math.cos(turn * spec[cycles])
                return _spread(spec[key], u)

            elevation = sweep("elevation_deg", "elevation_cycles")
            dolly = sweep("dolly", "dolly_cycles")
        else:
            raise ValueError(f"unknown poses kind {spec['kind']!r}")
        eye = orbit_eye(target, distance * dolly, azimuth,
                        math.radians(elevation))
        views.append(look_at(eye, target))
    return views


def visits(kind: str, n: int, rng: np.random.Generator):
    """The pose indices a loop visits, without end: 'epochs', a fresh
    shuffle of all n poses each epoch, drawn from `rng`; 'cycle', the path
    in order from its first pose, lap after lap, so that every seed's
    window holds the same frames."""
    if kind == "epochs":
        while True:
            yield from (int(i) for i in rng.permutation(n))
    elif kind == "cycle":
        while True:
            yield from range(n)
    else:
        raise ValueError(f"unknown visit order {kind!r}")
