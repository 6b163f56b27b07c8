"""The properties the visibility kernel K2 relies on, held on the plain
version (ops/kernels/rasterize.py) and the JAX kernel in interpret mode, and
chip_smoke.py's bound for K2.

The CUDA kernel compacts each staged group of slots to its live ones (valid
and non-degenerate), in slot order and with their original indices, and
walks only those. That is exact when (1) nothing of an invalid slot reaches
the result, not even a NaN or an infinity in its corners, and (2) a tile's
result is that of its live slots alone, in their order, with their slot
indices mapped back. Both are checked here bit for bit."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.ops.pallas import rasterize as jras
from avi_talking_tpu_torch.ops.kernels import rasterize as tras
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(seed, n, cap, px_n, valid_share=0.6):
    """Small faces around random centres, so that pixels are covered by a
    few faces each; degenerate faces, exact duplicates (z ties) and invalid
    slots."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-1.0, 1.0, (n, cap, 1, 3))
    tri = (centre + 0.5 * rng.uniform(-1.0, 1.0, (n, cap, 3, 3))).reshape(n, cap, 9)
    tri = tri.astype(np.float32)
    tri[:, ::7, 3:6] = tri[:, ::7, 0:3]  # degenerate: two equal corners
    tri[:, 1::5] = tri[:, 0:-1:5]  # exact duplicate of the previous slot
    valid = (rng.random((n, cap, 1)) < valid_share).astype(np.float32)
    px = rng.uniform(-1.0, 1.0, (n, px_n)).astype(np.float32)
    py = rng.uniform(-1.0, 1.0, (n, px_n)).astype(np.float32)
    return tri, valid, px, py


def _plain(tri, valid, px, py, chunk=256):
    z, s = tras.rasterize_tiles_visibility_reference(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (tri, valid, px, py)), chunk=chunk)
    return z.numpy(), s.numpy()


@pytest.mark.parametrize("poison", [np.nan, np.inf, -np.inf])
def test_invalid_slots_corners_never_reach_the_result(poison):
    """NaN or +-inf in every corner value of the invalid slots leaves zbuf
    and slot bit for bit as they were in the plain version; the JAX kernel
    (interpret mode) on the poisoned input agrees with them as the port's
    parity tests hold it (slots equal, z within 1e-6: XLA may contract)."""
    tri, valid, px, py = _case(1, 3, 64, 48)
    z, s = _plain(tri, valid, px, py, chunk=32)
    poisoned = np.where(valid > 0, tri, np.float32(poison)).astype(np.float32)
    pz, ps = _plain(poisoned, valid, px, py, chunk=32)
    assert (s >= 0).any() and (s < 0).any()
    np.testing.assert_array_equal(ps, s)
    assert np.array_equal(pz.view(np.int32), z.view(np.int32))
    jz, js = jras.rasterize_tiles_visibility(*(jnp.asarray(a) for a in (poisoned, valid, px, py)),
                                             chunk=32, interpret=True)
    np.testing.assert_array_equal(np.asarray(js), s)
    np.testing.assert_allclose(np.asarray(jz), z, atol=1e-6, rtol=0)


def test_permuting_invalid_slots_changes_nothing():
    """The corners of the invalid slots shuffled among those slots (each
    tile its own permutation): zbuf and slot bit for bit as they were."""
    tri, valid, px, py = _case(2, 4, 300, 37)
    rng = np.random.default_rng(0)
    shuffled = tri.copy()
    for t in range(tri.shape[0]):
        dead = np.flatnonzero(valid[t, :, 0] == 0)
        shuffled[t, dead] = tri[t, rng.permutation(dead)]
    assert not np.array_equal(shuffled, tri)
    z, s = _plain(tri, valid, px, py)
    sz, ss = _plain(shuffled, valid, px, py)
    np.testing.assert_array_equal(ss, s)
    assert np.array_equal(sz.view(np.int32), z.view(np.int32))


@pytest.mark.parametrize("mask", ["random", "tail", "alternate", "one", "none"])
def test_live_slots_alone_in_order_give_the_result(mask):
    """A tile's result is that of its live slots alone, moved to the front
    in their order (the rest invalid), with each winning slot mapped back to
    its original index: the compaction the kernel does in each staged
    group, over the whole tile at once. Live slots only at the tail, one
    live slot, none."""
    n, cap, px_n = 3, 300, 64
    tri, valid, px, py = _case(3, n, cap, px_n)
    slots = np.arange(cap)
    live_of = {"random": valid[..., 0] > 0,
               "tail": np.broadcast_to(slots >= cap - 90, (n, cap)),
               "alternate": np.broadcast_to(slots % 2 == 1, (n, cap)),
               "one": np.broadcast_to(slots == 257, (n, cap)),
               "none": np.zeros((n, cap), bool)}[mask]
    valid = live_of[..., None].astype(np.float32)
    z, s = _plain(tri, valid, px, py)
    packed, packed_valid = np.zeros_like(tri), np.zeros_like(valid)
    index = np.full((n, cap), -1)
    for t in range(n):
        live = np.flatnonzero(live_of[t])
        packed[t, :len(live)] = tri[t, live]
        packed_valid[t, :len(live)] = 1.0
        index[t, :len(live)] = live
    pz, ps = _plain(packed, packed_valid, px, py)
    mapped = np.where(ps >= 0, np.take_along_axis(index, np.maximum(ps, 0), 1), -1)
    np.testing.assert_array_equal(mapped, s)
    assert np.array_equal(pz.view(np.int32), z.view(np.int32))
    assert (s >= 0).any() == (mask != "none")


def _pair_counts(tri, valid, px, py):
    """(pixel, slot) pairs of live, non-degenerate faces, counted with numpy
    in the plain version's arithmetic: covered, and in the face's bounding
    box or covered."""
    x0, y0, x1, y1, x2, y2 = (tri[..., i][..., None] for i in (0, 1, 3, 4, 6, 7))
    denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    ok = (np.abs(denom) > 1e-12) & (valid > 0)
    inv = np.float32(1.0) / np.where(ok, denom, np.float32(1.0))
    qx, qy = px[:, None], py[:, None]
    dx, dy = qx - x2, qy - y2
    w0 = ((y1 - y2) * dx + (x2 - x1) * dy) * inv
    w1 = ((y2 - y0) * dx + (x0 - x2) * dy) * inv
    w2 = np.float32(1.0) - w0 - w1
    hit = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ok
    xs, ys = np.stack([x0, x1, x2]), np.stack([y0, y1, y2])
    in_box = ((qx >= xs.min(0)) & (qx <= xs.max(0)) & (qy >= ys.min(0)) & (qy <= ys.max(0)))
    return int(hit.sum()), int(((in_box & ok) | hit).sum()), int(ok.sum()) * px.shape[1]


@pytest.mark.parametrize("n,cap,px_n", [(2, 8, 16), (4, 256, 1024)])
def test_visibility_bound_counts_pairs_and_halves_the_fma_rate(n, cap, px_n):
    """chip_smoke.visibility_bound: 15 operations per (pixel, live slot)
    pair whose pixel lies in the face's bounding box or is covered, and 6
    more per covered pair, the counts of these inputs, and the corners of
    valid slots alone among the bytes; the no-FMA bound is
    the same count at half the FMA peak, so twice the FMA bound where
    operations bind, and equal to it where bytes bind."""
    cs = _chip_smoke()
    tri, valid, px, py = _case(4, n, cap, px_n)
    covered, pairs, walked = _pair_counts(tri, valid, px, py)
    assert 0 < covered < pairs < walked
    args = [torch.from_numpy(a) for a in (tri, valid, px, py)]
    for peaks in (cs.PEAKS["SXM"], (67e12, 1e30, 495e12)):
        b = cs.visibility_bound(*args, peaks)
        assert (b["covered_pairs"], b["pairs"], b["walked_pairs"]) == (covered, pairs, walked)
        assert b["flops"] == 15 * pairs + 6 * covered
        assert b["bytes"] == 4 * n * cap + 36 * int((valid > 0).sum()) + 16 * n * px_n
        t_ops, t_bytes = b["flops"] / peaks[0] * 1e3, b["bytes"] / peaks[1] * 1e3
        assert b["bound_ms"] == pytest.approx(max(t_ops, t_bytes), rel=1e-12)
        assert b["bound_ms_no_fma"] == pytest.approx(max(2 * t_ops, t_bytes), rel=1e-12)
        if b["bound_no_fma_by"] == "operations" and b["bound_by"] == "operations":
            assert b["bound_ms_no_fma"] == pytest.approx(2 * b["bound_ms"], rel=1e-12)
    assert cs.visibility_bound(*args, (67e12, 1e30, 495e12))["bound_by"] == "operations"


@pytest.mark.parametrize("n,px_n,blocks", [(64, 1024, 256), (16, 3136, 208), (70000, 7, 65535)])
def test_visibility_launch_from_source_and_ptxas(n, px_n, blocks):
    """chip_smoke.visibility_launch: blocks of 256 one-pixel threads, one
    per pixel block and tile, at most 65535 tiles a grid row; registers,
    shared memory and blocks per SM from a ptxas line."""
    cs = _chip_smoke()
    line = ["ptxas info    : Used 37 registers, used 1 barriers, 12320 bytes smem"]
    launch = cs.visibility_launch(n, px_n, line)
    assert launch == {"blocks": blocks, "threads": 256, "pixels_per_block": 256,
                      "registers": 37, "smem_bytes": 12320, "blocks_per_sm": 6}
    assert cs.visibility_launch(n, px_n, []) == {"blocks": blocks, "threads": 256,
                                                 "pixels_per_block": 256}


def test_live_slot_stats():
    cs = _chip_smoke()
    valid = torch.zeros(5, 8, 1)
    valid[1, :3] = 1
    valid[2] = 1
    valid[4, 7] = 1
    stats = cs.live_slot_stats(valid)
    assert stats.pop("mean") == pytest.approx(12 / 5)
    assert stats == {"median": 1.0, "max": 8, "empty_tiles": 2, "tiles_at_cap": 1, "tiles": 5}
