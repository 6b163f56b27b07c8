"""Dependency-free PNG writer (a numpy / zlib copy of ``write_png`` in
``avi_talking_tpu/viz/pngio.py``; the readers come with the preprocessing
slice)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, img_u8: np.ndarray) -> None:
    """Minimal PNG writer (8-bit gray/RGB/RGBA, filter 0 rows)."""
    if img_u8.ndim == 2:
        img_u8 = img_u8[..., None]
    h, w, c = img_u8.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    raw = b"".join(b"\x00" + img_u8[i].tobytes() for i in range(h))

    def chunk(tag, body):
        out = struct.pack(">I", len(body)) + tag + body
        return out + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", header))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))
