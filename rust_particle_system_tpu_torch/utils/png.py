"""Minimal dependency-free PNG writer (RGBA8), for CLI frame dumps.

A copy of ``rust_particle_system_tpu/utils/png.py`` (numpy + zlib), so that the
port needs nothing of the JAX package."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, image_u8: np.ndarray) -> None:
    """Write an [H, W, 4] uint8 array as an RGBA PNG."""
    img = np.asarray(image_u8)
    assert img.ndim == 3 and img.shape[2] == 4 and img.dtype == np.uint8
    h, w = img.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)  # 8-bit RGBA
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
