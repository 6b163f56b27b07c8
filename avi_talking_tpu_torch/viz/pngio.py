"""PNG read / write (a copy of ``avi_talking_tpu/viz/pngio.py``; host only).

``read_png`` decodes 8-bit gray / gray+alpha / RGB / RGBA / palette PNGs
(non-interlaced) to a (H, W, C) uint8 array. It decodes with the C++
decoder of ``native/imageio.cpp`` (``_read_png_native``, over the library
``infra.native_build`` builds at first use; a failed build raises), as the
JAX package does once its library is built, and, as there, a file the
native decoder refuses (a palette image, or a malformed one) goes to
``_read_png_python``, the pure-Python decoder, which decodes it or raises
its own error. The Python decoder is also the plain version the tests hold
the native one to.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from ..infra import native_build

_CHANNELS = {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}  # colour type -> output channels


def _load_native() -> ctypes.CDLL:
    lib = native_build.load("imageio")
    lib.imageio_read_png.restype = ctypes.c_int64
    lib.imageio_read_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),  # w
        ctypes.POINTER(ctypes.c_int32),  # h
        ctypes.POINTER(ctypes.c_int32),  # c
    ]
    return lib


def _read_png_native(path: str, lib: ctypes.CDLL) -> np.ndarray:
    """Raises ``ValueError`` with the decoder's code for a file it does not
    decode (-3: a palette image, a depth other than 8 or interlacing; -1 /
    -4: malformed)."""
    w, h, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    cap = os.path.getsize(path) * 64 + (1 << 20)  # a generous inflate bound
    buf = np.empty(cap, np.uint8)
    n = lib.imageio_read_png(str(path).encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                             cap, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c))
    if n == -2:  # capacity: retry with the exact size, which w carries
        buf = np.empty(w.value, np.uint8)
        n = lib.imageio_read_png(str(path).encode(),
                                 buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
                                 ctypes.byref(w), ctypes.byref(h), ctypes.byref(c))
    if n < 0:
        raise ValueError(f"native PNG decode failed ({n}): {path}")
    return buf[:n].reshape(h.value, w.value, c.value).copy()


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a.astype(np.int32) + b.astype(np.int32) - c.astype(np.int32)
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)).astype(np.uint8)


def _unfilter(raw: bytes, h: int, w: int, ch: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) of ``h`` rows
    of ``w * ch`` bytes, each led by its filter byte."""
    stride = w * ch
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = raw[pos]
        row = np.frombuffer(raw, np.uint8, stride, pos + 1).copy()
        pos += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub: a mod-256 running sum per channel lane
            row = np.cumsum(row.reshape(w, ch), axis=0, dtype=np.uint64).astype(
                np.uint8).reshape(stride)
        elif ftype == 2:  # Up
            row = (row.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 3:  # Average
            r = row.reshape(w, ch).astype(np.int32)
            p = prev.reshape(w, ch).astype(np.int32)
            acc = np.zeros(ch, np.int32)
            rows = []
            for x in range(w):
                acc = (r[x] + ((acc + p[x]) >> 1)) & 0xFF
                rows.append(acc)
            row = np.stack(rows).astype(np.uint8).reshape(stride)
        elif ftype == 4:  # Paeth
            r = row.reshape(w, ch)
            p = prev.reshape(w, ch)
            left = np.zeros(ch, np.uint8)
            ul = np.zeros(ch, np.uint8)
            rows = []
            for x in range(w):
                left = ((r[x].astype(np.int32) + _paeth(left, p[x], ul)) & 0xFF).astype(np.uint8)
                ul = p[x]
                rows.append(left)
            row = np.stack(rows).reshape(stride)
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        out[y] = row
        prev = out[y]
    return out


def _read_png_python(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"not a PNG: {path}")
    pos = 8
    idat = b""
    plte = trns = None
    w = h = depth = ctype = interlace = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    if depth != 8:
        raise ValueError(f"only 8-bit PNGs supported (depth={depth}): {path}")
    if interlace:
        raise ValueError(f"interlaced PNGs not supported: {path}")
    if ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG color type {ctype}: {path}")
    raw_ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    img = _unfilter(zlib.decompress(idat), h, w, raw_ch).reshape(h, w, raw_ch)
    if ctype == 3:  # palette
        if plte is None:
            raise ValueError(f"palette PNG missing PLTE: {path}")
        idx = img[..., 0]
        rgb = plte[idx]
        if trns is not None:
            alpha = np.full(256, 255, np.uint8)
            alpha[:len(trns)] = trns
            return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
        return rgb
    return img


def read_png(path: str) -> np.ndarray:
    """Decode to (H, W, C) uint8 (C = 1 / 2 / 3 / 4 by colour type): the
    native decoder, or the Python one for a file the native one refuses."""
    lib = _load_native()
    try:
        return _read_png_native(path, lib)
    except ValueError:
        return _read_png_python(path)


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


def read_image_u8(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB: gray is repeated, alpha dropped."""
    img = read_png(path)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    elif img.shape[-1] in (2, 4):
        img = img[..., :3] if img.shape[-1] == 4 else np.repeat(img[..., :1], 3, -1)
    return img


def read_image_normalized(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [-1, 1], NHWC (the reference's to_Tensor scale)."""
    return read_image_u8(path).astype(np.float32) / 255.0 * 2.0 - 1.0
