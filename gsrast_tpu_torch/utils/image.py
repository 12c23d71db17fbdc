"""PNG output and input with zlib, struct and numpy only (no PIL)."""

from __future__ import annotations

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


# Colour type -> channels, for the 8-bit non-interlaced PNGs `load_png` reads.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # gray, RGB, gray + alpha, RGBA


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec section 9). None, Sub and Up
    run over whole rows; Average and Paeth step through the row's pixels."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along each channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth
            cur = line.astype(np.int32)
            up = prior.astype(np.int32)
            for x in range(0, stride, bpp):
                left = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                above = up[x:x + bpp]
                if kind == 3:
                    pred = (left + above) // 2
                else:
                    corner = up[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    p = left + above - corner
                    pa, pb, pc = (np.abs(p - left), np.abs(p - above),
                                  np.abs(p - corner))
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, above, corner))
                cur[x:x + bpp] = (cur[x:x + bpp] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"PNG scanline {y}: unknown filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def load_png(path: str) -> np.ndarray:
    """Read an 8-bit gray, gray + alpha, RGB or RGBA non-interlaced PNG as
    an (H, W, 3) float32 image in [0, 1]: gray is repeated to three
    channels and alpha is dropped, as the reference's
    `Image.open(path).convert("RGB")` does. Anything else (16-bit,
    palette, interlaced, not a PNG) raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file (JPEG and other formats "
                         "are not read)")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[
            pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: PNG with bit depth {depth}, colour type {color}, "
            f"interlace {interlace} is not read; only 8-bit gray, gray + "
            "alpha, RGB and RGBA without interlacing are")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * ch + 1):
        raise ValueError(f"{path}: image data has {raw.size} bytes, "
                         f"expected {h * (w * ch + 1)}")
    pix = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    rgb = np.repeat(pix[..., :1], 3, axis=2) if ch < 3 else pix[..., :3]
    return rgb.astype(np.float32) / 255.0
