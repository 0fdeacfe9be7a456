"""Minimal 8-bit grayscale PNG writer (stdlib zlib only).

Replaces the reference's vendored lodepng (reference: rasterization/src/cpp/
lodepng.{h,cpp}, used by the demo's ``save_png_grayscale``,
rasterization/src/cpp/main.cpp:17-38) for density-slice dumps.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png_grayscale(path: str, image: np.ndarray) -> None:
    """Write a 2D array as an 8-bit grayscale PNG (auto-scaled to [0, 255])."""
    img = np.asarray(image, dtype=np.float64)
    if img.ndim != 2:
        raise ValueError("image must be 2D")
    lo, hi = float(img.min()), float(img.max())
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    data = np.clip(np.round((img - lo) * scale), 0, 255).astype(np.uint8)

    h, w = data.shape
    raw = b"".join(b"\x00" + data[row].tobytes() for row in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)
