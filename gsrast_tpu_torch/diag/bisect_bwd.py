"""Fault-bisection kernels: the blend backward's access pattern in small.

    python -m gsrast_tpu_torch.diag.bisect_bwd [--device cuda|cpu]

Counterpart of the reference's `scripts/bisect_bwd.py`, whose four toy
kernels reproduce the tile-blend backward's walk: per tile, its chunks of
128 intersections (16 rows of `feat`'s 128 lanes, starting at row
`starts[t] // 8`) newest first, double-buffered copies, and a carried
transmittance-like recurrence with a reduction per step. On the card they
are the kernels of `csrc/bisect_bwd.cu`, a small harness for finding faults
in a later redesign of the blend backward (async staging, reversed chunk
walks). What each computes, for every tile t with
`nchunks = (starts[t+1] - starts[t]) // 128` and chunk k walked
`nchunks-1 ... 0`:

  A: out[chunk] = 2 feat[chunk].
  B: row r = 15 ... 0 of the chunk: lane 16 j (j = 0..7) = 3 feat[r, 16 j],
     0 on the other lanes.
  C: a carry t_run (8, 128) starts at ones per tile; step (k, r, j), r
     descending and j ascending, takes v = feat[r, 16 j], sets
     t_run /= 1 + 0.001 v, and writes sum(t_run v) to lane 16 j of row r.
  D: as C, with idx = 128 k + 8 r + j, a = 0.001 v where idx < nc[t] and
     v > 0.1 (elementwise), else 0; t_run /= 1 + a; the sum is of
     t_run drgb[t, 0] ft[t].

Rows that no full chunk covers stay 0. On the card A stages whole chunks;
B reads only the 8 values of each row it uses, into registers, three
chunks ahead of the one it writes, and writes each row whole (the L2
fetches 64-byte granules, so those reads still cost every byte of feat:
`diag/bisect_timing.py --probe`); C and D stage only the 128 values a
chunk's steps read, make a
table of each step's divisor and its correctly rounded reciprocal once a
chunk, divide each carry element by one correction of that reciprocal (the
bits of IEEE division; `__fdiv_rn` where the carry is under 2^-100 or a
divisor outside [1, 2^20]), and sum a row's 8 steps in one transposing warp
reduction, in a fixed order (two launches, the same bits); their blocks
take the tiles longest first (`tile_order_cuda`, a launch of its own). Each
kernel has a plain PyTorch version (`bisect_*_torch`, any device), which
the CPU runs and the kernel is checked against, and a wrapper
(`bisect_*_cuda`, CUDA tensors only) that launches the kernel or raises.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..render.blend import tile_order_cuda

ROWS, LANES = 16, 128
CHUNK = ROWS * 8      # intersections per chunk
CARRY = (8, LANES)    # the carried recurrence's shape
# The reference script's inputs: four tiles of 2, 1, 0 and 1 chunks.
SCRIPT_COUNTS = (2 * 128, 128, 0, 128)
CARRIED = ("c", "d")  # the kernels that carry the recurrence
NAMES = {"a": "A-readwrite", "b": "B-scalars", "c": "C-carries",
         "d": "D-blocked-ins"}


def script_inputs(device="cpu") -> Dict[str, torch.Tensor]:
    """The reference script's inputs: starts (5,) = [0, 256, 384, 384, 512],
    feat = arange(R * 128) as (R, 128), and ones for ft, nc and drgb."""
    starts = np.concatenate([[0], np.cumsum(SCRIPT_COUNTS)]).astype(np.int32)
    t, rows = len(SCRIPT_COUNTS), int(starts[-1]) // 8
    return {
        "starts": torch.tensor(starts, device=device),
        "feat": torch.arange(rows * LANES, dtype=torch.float32,
                             device=device).reshape(rows, LANES),
        "ft": torch.ones((t, *CARRY), device=device),
        "nc": torch.ones((t, *CARRY), dtype=torch.int32, device=device),
        "drgb": torch.ones((t, 3, *CARRY), device=device),
    }


def _check(starts: torch.Tensor, feat: torch.Tensor, **blocks) -> None:
    """Shapes, types and bounds the kernels assume; every tile's full
    chunks must lie inside feat's rows (checked on the host)."""
    if starts.dtype != torch.int32 or starts.dim() != 1 or len(starts) < 1:
        raise ValueError(f"starts must be (T+1,) int32, got "
                         f"{tuple(starts.shape)} {starts.dtype}")
    if feat.dtype != torch.float32 or feat.dim() != 2 or (
            feat.shape[1] != LANES):
        raise ValueError(f"feat must be (R, {LANES}) float32, got "
                         f"{tuple(feat.shape)} {feat.dtype}")
    t = len(starts) - 1
    shapes = {"ft": ((t, *CARRY), torch.float32),
              "nc": ((t, *CARRY), torch.int32),
              "drgb": ((t, 3, *CARRY), torch.float32)}
    for name, x in blocks.items():
        shape, dtype = shapes[name]
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
    s = starts.cpu().long()
    nch = (s[1:] - s[:-1]).div(CHUNK, rounding_mode="floor")
    has = nch > 0
    row0 = s[:-1].div(8, rounding_mode="floor")
    if bool(has.any()) and (int(row0[has].min()) < 0 or int(
            (row0 + ROWS * nch)[has].max()) > feat.shape[0]):
        raise ValueError(f"a tile's chunks fall outside feat's "
                         f"{feat.shape[0]} rows")


def _steps(starts: torch.Tensor, num_rows: int):
    """Per tile, the recurrence's steps in the kernels' order: (row, lane,
    idx, valid), each (T, S) with S the longest tile's 128 * nchunks."""
    dev = starts.device
    s = starts.long()
    nch = torch.clamp((s[1:] - s[:-1]).div(CHUNK, rounding_mode="floor"),
                      min=0)
    row0 = s[:-1].div(8, rounding_mode="floor")
    i = torch.arange(int(nch.max()) * CHUNK if len(nch) else 0, device=dev)
    k = nch[:, None] - 1 - i // CHUNK
    r = ROWS - 1 - (i % CHUNK) // 8
    j = i % 8
    valid = k >= 0
    row = torch.where(valid, row0[:, None] + ROWS * k + r, 0).clamp(
        0, max(num_rows - 1, 0))
    return row, 16 * j.expand_as(row), CHUNK * k + 8 * r + j, valid


def bisect_a_torch(starts: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """A, the plain version: every full chunk's rows doubled."""
    _check(starts, feat)
    row, _, _, valid = _steps(starts, feat.shape[0])
    rows = row[valid].unique()  # each row of a chunk appears in 8 steps
    out = torch.zeros_like(feat)
    out[rows] = 2.0 * feat[rows]
    return out


def bisect_b_torch(starts: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """B, the plain version: lanes 16 j of every full chunk's rows tripled,
    the other lanes of those rows 0."""
    _check(starts, feat)
    row, lane, _, valid = _steps(starts, feat.shape[0])
    out = torch.zeros_like(feat)
    out[row[valid], lane[valid]] = 3.0 * feat[row[valid], lane[valid]]
    return out


def _carried(starts: torch.Tensor, feat: torch.Tensor, step) -> torch.Tensor:
    """C and D: the steps run in order, all tiles at once; `step(t_run, v,
    idx)` returns (the new carry, the step's sums), both per tile. A tile
    past its last step reads v = 0, which leaves its carry as it is."""
    row, lane, idx, valid = _steps(starts, feat.shape[0])
    vals = torch.where(valid, feat[row, lane], 0.0)
    sums = torch.empty_like(vals)
    t_run = torch.ones((len(starts) - 1, *CARRY), dtype=torch.float32,
                       device=feat.device)
    for i in range(vals.shape[1]):
        t_run, sums[:, i] = step(t_run, vals[:, i, None, None],
                                 idx[:, i, None, None])
    out = torch.zeros_like(feat)
    out[row[valid], lane[valid]] = sums[valid]
    return out


def bisect_c_torch(starts: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """C, the plain version: t_run /= 1 + 0.001 v, then sum(t_run v)."""
    _check(starts, feat)

    def step(t_run, v, _idx):
        t_run = t_run / (1.0 + 0.001 * v)
        return t_run, torch.sum(t_run * v, dim=(1, 2))

    return _carried(starts, feat, step)


def bisect_d_torch(starts: torch.Tensor, feat: torch.Tensor,
                   ft: torch.Tensor, nc: torch.Tensor,
                   drgb: torch.Tensor) -> torch.Tensor:
    """D, the plain version: C's recurrence gated by idx < nc and v > 0.1,
    summing t_run drgb[:, 0] ft."""
    _check(starts, feat, ft=ft, nc=nc, drgb=drgb)
    dc = drgb[:, 0]

    def step(t_run, v, idx):
        applied = (idx < nc) & (v > 0.1)
        a = torch.where(applied, 0.001 * v, 0.0)
        t_run = t_run / (1.0 + a)
        return t_run, torch.sum(t_run * dc * ft, dim=(1, 2))

    return _carried(starts, feat, step)


def _launch(name: str, starts: torch.Tensor, feat: torch.Tensor,
            blocks: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
    tensors = (starts, feat, *blocks)
    if feat.device.type != "cuda" or any(x.device != feat.device
                                         for x in tensors):
        raise ValueError(f"bisect_{name}_cuda needs all inputs on one CUDA "
                         f"device, got {[str(x.device) for x in tensors]}")
    starts, feat, *blocks = (x.contiguous() for x in tensors)
    if feat.data_ptr() % 16:
        feat = feat.clone()  # the kernel copies 16 bytes at a time
    out = torch.zeros_like(feat)
    fn = getattr(_kernels.load().lib, f"gsrast_bisect_{name}")
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        ptrs = [starts.data_ptr(), len(starts) - 1, feat.data_ptr(),
                *(x.data_ptr() for x in blocks)]
        if name in CARRIED:  # the blocks take the longest tiles first
            order = tile_order_cuda(starts)
            ptrs.append(order.data_ptr())
        code = fn(*ptrs, out.data_ptr(), stream)
    _kernels.launch_counts[f"bisect_{name}"] += 1
    if code != 0:
        raise RuntimeError(f"bisect_{name} kernel launch failed: CUDA error "
                           f"{code}")
    return out


def bisect_a_cuda(starts: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """A on the card (`csrc/bisect_bwd.cu`); runs on the current stream."""
    _check(starts, feat)
    return _launch("a", starts, feat)


def bisect_b_cuda(starts: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """B on the card (`csrc/bisect_bwd.cu`); runs on the current stream."""
    _check(starts, feat)
    return _launch("b", starts, feat)


def bisect_c_cuda(starts: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """C on the card (`csrc/bisect_bwd.cu`); runs on the current stream."""
    _check(starts, feat)
    return _launch("c", starts, feat)


def bisect_d_cuda(starts: torch.Tensor, feat: torch.Tensor, ft: torch.Tensor,
                  nc: torch.Tensor, drgb: torch.Tensor) -> torch.Tensor:
    """D on the card (`csrc/bisect_bwd.cu`); runs on the current stream."""
    _check(starts, feat, ft=ft, nc=nc, drgb=drgb)
    return _launch("d", starts, feat, (ft, nc, drgb))


KERNELS = {"a": (bisect_a_cuda, bisect_a_torch),
           "b": (bisect_b_cuda, bisect_b_torch),
           "c": (bisect_c_cuda, bisect_c_torch),
           "d": (bisect_d_cuda, bisect_d_torch)}


def kernel_args(name: str, inputs: Dict[str, torch.Tensor]) -> tuple:
    keys = ("starts", "feat") + (("ft", "nc", "drgb") if name == "d" else ())
    return tuple(inputs[k] for k in keys)


def main(argv: Optional[list] = None) -> Dict[str, torch.Tensor]:
    """Run A-D on the reference script's inputs and print the script's
    lines (`A-readwrite: OK <sum>` ...). On `cuda` the kernels run, and a
    kernel that fails to build or launch raises; on `cpu` the plain
    versions run. Returns the four outputs by name."""
    ap = argparse.ArgumentParser(prog="python -m gsrast_tpu_torch.diag."
                                      "bisect_bwd")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("--device cuda: no CUDA device is available; pass "
                     "--device cpu to run the plain versions")
        print(f"device: cuda ({torch.cuda.get_device_name()}): the kernels "
              "of csrc/bisect_bwd.cu")
    else:
        print("device: cpu: the plain PyTorch versions; no kernel runs")
    inputs = script_inputs(args.device)
    outs = {}
    for name, (cuda_fn, torch_fn) in KERNELS.items():
        fn = cuda_fn if args.device == "cuda" else torch_fn
        outs[name] = fn(*kernel_args(name, inputs))
        if args.device == "cuda":
            torch.cuda.synchronize()  # a fault in the run surfaces here
        print(f"{NAMES[name]}: OK", float(outs[name].sum()))
    return outs


if __name__ == "__main__":
    main()
