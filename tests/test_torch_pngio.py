"""Port parity, the PNG readers: the port's pure-Python decoder and its
readers (``read_png``, ``read_image_u8``, ``read_image_normalized``) are
bit-equal to the JAX package's ``_read_png_python`` and readers on the
golden all-filters fixture and on gray, gray+alpha, RGB, RGBA and palette
PNGs (with and without transparency, rows under every filter type), and
reject the malformed files JAX rejects, with its messages."""

import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from avi_talking_tpu.viz import pngio as jpng
from avi_talking_tpu_torch.viz import pngio as tpng
from _torch_threads import one_torch_thread  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"


def _chunk(tag, body):
    out = struct.pack(">I", len(body)) + tag + body
    return out + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)


def _filtered_rows(img: np.ndarray, rng) -> bytes:
    """Rows encoded under filters drawn from 0-4 (the decoder's inverse)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    prev = np.zeros(w * c, np.int32)
    out = b""
    for y in range(h):
        f = int(rng.integers(0, 5))
        cur = rows[y]
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - ((left + prev) >> 1)
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
            enc = cur - pred
        out += bytes([f]) + (enc & 0xFF).astype(np.uint8).tobytes()
        prev = cur
    return out


def _png(path, img, ctype, depth=8, interlace=0, plte=None, trns=None, rng=None):
    h, w = img.shape[:2]
    raw = _filtered_rows(img, rng or np.random.default_rng(0))
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        body += _chunk(b"PLTE", plte.tobytes())
    if trns is not None:
        body += _chunk(b"tRNS", trns.tobytes())
    raw_z = zlib.compress(raw)
    # IDAT split in two chunks: the decoder joins them
    body += _chunk(b"IDAT", raw_z[:len(raw_z) // 2]) + _chunk(b"IDAT", raw_z[len(raw_z) // 2:])
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IEND", b""))


def _both(fn_name, path):
    got = getattr(tpng, fn_name)(str(path))
    ref = getattr(jpng, fn_name)(str(path))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


def test_golden_all_filters_match_jax():
    want = np.load(GOLDEN / "mixed_filters_expected.npy")
    got = tpng._read_png_python(str(GOLDEN / "mixed_filters.png"))
    np.testing.assert_array_equal(got, jpng._read_png_python(str(GOLDEN / "mixed_filters.png")))
    np.testing.assert_array_equal(got, want)
    for fn in ("read_png", "read_image_u8", "read_image_normalized"):
        _both(fn, GOLDEN / "mixed_filters.png")


@pytest.mark.parametrize("ctype,channels", [(0, 1), (4, 2), (2, 3), (6, 4)])
def test_every_colour_type_and_filter_matches_jax(tmp_path, ctype, channels):
    rng = np.random.default_rng(ctype)
    img = rng.integers(0, 256, (13, 11, channels), dtype=np.uint8)
    p = tmp_path / "x.png"
    _png(p, img, ctype, rng=rng)
    np.testing.assert_array_equal(_both("_read_png_python", p), img)
    for fn in ("read_png", "read_image_u8", "read_image_normalized"):
        _both(fn, p)
    # and the port's writer's file, read by both
    tpng.write_png(str(p), img)
    np.testing.assert_array_equal(_both("_read_png_python", p), img)


@pytest.mark.parametrize("with_trns", [False, True])
def test_palette_matches_jax(tmp_path, with_trns):
    rng = np.random.default_rng(7)
    plte = rng.integers(0, 256, (5, 3), dtype=np.uint8)
    idx = rng.integers(0, 5, (9, 6, 1), dtype=np.uint8)
    trns = np.array([0, 128, 255], np.uint8) if with_trns else None
    p = tmp_path / "pal.png"
    _png(p, idx, 3, plte=plte, trns=trns, rng=rng)
    got = _both("_read_png_python", p)
    assert got.shape == (9, 6, 4 if with_trns else 3)
    np.testing.assert_array_equal(got[..., :3], plte[idx[..., 0]])
    for fn in ("read_image_u8", "read_image_normalized"):
        _both(fn, p)


def _malformed(tmp_path, kind):
    p = tmp_path / f"{kind}.png"
    img = np.zeros((4, 4, 3), np.uint8)
    if kind == "not_png":
        p.write_bytes(b"not a png at all")
    elif kind == "depth16":
        _png(p, img, 2, depth=16)
    elif kind == "interlaced":
        _png(p, img, 2, interlace=1)
    elif kind == "colour_type_5":
        _png(p, img, 5)
    elif kind == "palette_without_plte":
        _png(p, img[..., :1], 3)
    else:  # a row under filter 9
        raw = b"".join(b"\x09" + img[y].tobytes() for y in range(4))
        p.write_bytes(b"\x89PNG\r\n\x1a\n"
                      + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 0))
                      + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
    return p


@pytest.mark.parametrize("kind", ["not_png", "depth16", "interlaced", "colour_type_5",
                                  "palette_without_plte", "bad_filter"])
def test_malformed_rejected_as_jax_rejects(tmp_path, kind):
    p = _malformed(tmp_path, kind)
    with pytest.raises(ValueError) as ref:
        jpng._read_png_python(str(p))
    with pytest.raises(ValueError) as got:
        tpng.read_png(str(p))
    assert str(got.value) == str(ref.value)
