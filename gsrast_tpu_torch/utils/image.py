"""PNG output with zlib, struct and numpy, image input through PIL, and
timestamped screenshots."""

from __future__ import annotations

import datetime
import os
import struct
import zlib

import numpy as np
import torch


def to_uint8(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    arr = np.asarray(img, np.float32)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF)


def save_png(img, path: str) -> str:
    """Write an (H, W, 3) image with values in [0, 1] as an 8-bit RGB PNG."""
    arr = to_uint8(img)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {arr.shape}")
    h, w, _ = arr.shape
    # Filter type 0 (none) at the start of every scanline.
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)],
                         axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
           + _chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)
    return path


def screenshot(img, directory: str = ".", prefix: str = "screenshot") -> str:
    """Save `img` as `<directory>/<prefix>_<YYYYmmdd_HHMMSS>.png`."""
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    return save_png(img, os.path.join(directory, f"{prefix}_{stamp}.png"))


def load_png(path: str) -> np.ndarray:
    """Read an image file of any format PIL reads (PNG, JPEG, ...) as an
    (H, W, 3) float32 image in [0, 1], as the reference does:
    `Image.open(path).convert("RGB")` / 255. PIL is imported only here;
    where it is missing, ImportError names the file."""
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError(f"reading {path} needs PIL (Pillow), which is not "
                          "installed") from err
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB")).astype(np.float32) / 255.0
