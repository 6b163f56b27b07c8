"""Port parity of the rasterizer (viz/rasterizer.py, viz/shading.py) and of
the plain version of the visibility kernel K2 (ops/kernels/rasterize.py):
the same numpy inputs through the JAX package (its Pallas kernel in
interpret mode) and through the port on the CPU.

Tolerances are those of the JAX suite: images 1e-5 (binned against dense or
Pallas: rtol 1e-4 / atol 1e-5, tests/test_pallas_attention.py), masks,
face ids and winning slots equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.ops.pallas import rasterize as jras
from avi_talking_tpu.viz import rasterizer as jr
from avi_talking_tpu.viz import shading as jshade
from avi_talking_tpu_torch.ops.kernels import rasterize as tras
from avi_talking_tpu_torch.viz import rasterizer as tr
from avi_talking_tpu_torch.viz import shading as tshade
from _torch_threads import one_torch_thread  # noqa: F401


def head_proxy_mesh(n_lat=48, n_lon=44):
    """FLAME-density stand-in: a closed head ellipsoid in NDC (front and
    back faces bin like FLAME's), 2 * n_lat * n_lon faces."""
    vs, fs = [], []
    for i in range(n_lat + 1):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            vs.append([0.58 * np.sin(th) * np.cos(ph), 0.78 * np.cos(th),
                       0.5 * np.sin(th) * np.sin(ph) + 0.6])
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            fs.append([a, b, a + n_lon])
            fs.append([b, b + n_lon, a + n_lon])
    return np.asarray(vs, np.float32), np.asarray(fs, np.int32)


def random_mesh(seed, V, F, B=None, C=3, lo=-0.9, hi=0.9):
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    verts = rng.uniform(lo, hi, lead + (V, 3)).astype(np.float32)
    faces = rng.integers(0, V, (F, 3)).astype(np.int32)
    attrs = rng.standard_normal(lead + (V, C)).astype(np.float32)
    return verts, faces, attrs


def t(a):
    return torch.from_numpy(np.asarray(a))


def assert_image(got, ref, rtol=0.0, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("per_corner", [False, True])
def test_dense_rasterize_matches_jax(per_corner):
    verts, faces, attrs = random_mesh(0, 60, 48)
    if per_corner:
        attrs = np.random.default_rng(1).standard_normal((48, 3, 4)).astype(np.float32)
    ji, jm = jr.rasterize(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(attrs), 24, 32,
                          16, per_corner)
    ti, tm = tr.rasterize(t(verts), t(faces), t(attrs), 24, 32, chunk=16, per_corner=per_corner)
    assert tm.any() and not tm.all()
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert_image(ti, ji)
    if not per_corner:  # frame by frame over a batch
        v2, a2 = np.stack([verts, verts[::-1].copy()]), np.stack([attrs, attrs * 2])
        bi, bm = tr.rasterize_batch(t(v2), t(faces), t(a2), 24, 32, chunk=16)
        jbi, jbm = jr.rasterize_batch(jnp.asarray(v2), jnp.asarray(faces), jnp.asarray(a2),
                                      24, 32, chunk=16)
        np.testing.assert_array_equal(bm.numpy(), np.asarray(jbm))
        assert_image(bi, jbi)


def test_pixel_grid_and_zbuffer_tie_go_to_lowest_face():
    """y up at row 0; two coincident faces: the lower id wins."""
    px, py = tr._pixel_grid(4, 2)
    jx, jy = jr._pixel_grid(4, 2)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    assert py[0, 0] > py[-1, 0]
    verts = np.asarray([[-1, -1, 0.5], [1, -1, 0.5], [0, 1, 0.5]], np.float32)
    faces = np.asarray([[0, 1, 2], [0, 1, 2]], np.int32)
    cattrs = np.stack([np.zeros((3, 1)), np.ones((3, 1))]).astype(np.float32)
    img, mask = tr.rasterize(t(verts), t(faces), t(cattrs), 8, 8, per_corner=True)
    assert mask.any() and float(img[mask].abs().max()) == 0.0


def test_vertex_normals_match_jax():
    verts, faces, _ = random_mesh(2, 50, 70, B=3)
    got = tr.compute_vertex_normals(t(verts), t(faces))
    ref = jr.compute_vertex_normals(jnp.asarray(verts), jnp.asarray(faces))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    single = tr.compute_vertex_normals(t(verts[0]), t(faces))
    np.testing.assert_array_equal(single.numpy(), got[0].numpy())
    # unused vertices keep a zero normal, not NaN
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("mesh", ["random", "head"])
def test_render_normal_maps_and_shaded_match_jax(mesh):
    """Dense route (a small random mesh) and binned route (the head mesh,
    4224 faces, binned by rasterize_auto at 64^2)."""
    if mesh == "random":
        verts, faces, _ = random_mesh(3, 80, 60, B=2)
    else:
        hv, faces = head_proxy_mesh()
        verts = np.stack([hv, hv * np.float32(0.9)])
    got = tr.render_normal_maps(t(verts), t(faces), 64, 64)
    ref = jr.render_normal_maps(jnp.asarray(verts), jnp.asarray(faces), 64, 64)
    assert_image(got, ref)
    got = tshade.render_shaded(t(verts), t(faces), 64, 64)
    ref = jshade.render_shaded(jnp.asarray(verts), jnp.asarray(faces), 64, 64)
    assert_image(got, ref)
    assert float(got.max()) > 0.0


def test_sh_basis_and_light_match_jax():
    n = np.random.default_rng(4).standard_normal((2, 5, 6, 3)).astype(np.float32)
    light = np.random.default_rng(5).standard_normal((2, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(tshade.sh_basis(t(n)).numpy(), np.asarray(jshade.sh_basis(n)),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tshade.add_sh_light(t(n), t(light)).numpy(),
                               np.asarray(jshade.add_sh_light(n, light)), atol=1e-5, rtol=0)


def _jax_bin(verts, faces, h, w, tile, cap):
    return jr._bin_faces(jnp.asarray(verts), jnp.asarray(faces), h, w, tile, cap)


@pytest.mark.parametrize("case", ["random_no_overflow", "random_overflow", "head_overflow_ties"])
def test_bin_faces_ids_equal_jax(case):
    """Face ids equal JAX's, overflowing tiles and tied zmin included: the
    head mesh at 64^2, tile 16, cap 64 drops faces at a tie of equal zmin
    (faces that share their nearest vertex)."""
    if case == "head_overflow_ties":
        verts, faces = head_proxy_mesh()
        h = w = 64
        tile, cap = 16, 64
    else:
        verts, faces, _ = random_mesh(6, 40, 30)
        h, w, tile = 32, 48, 16
        cap = 64 if case == "random_no_overflow" else 8
    ids, tri_p, pxg, pyg, grid = tr._bin_faces(t(verts), t(faces), h, w, tile, cap)
    jids, jtri_p, jpxg, jpyg, jgrid = _jax_bin(verts, faces, h, w, tile, cap)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tri_p.numpy(), np.asarray(jtri_p))
    np.testing.assert_array_equal(pxg.numpy(), np.asarray(jpxg))
    np.testing.assert_array_equal(pyg.numpy(), np.asarray(jpyg))
    assert grid == jgrid
    counts = tr._face_tile_overlap(t(verts), t(faces), h, w, tile).sum(-1)
    if case == "random_no_overflow":
        assert int(counts.max()) <= cap
    else:
        assert int(counts.max()) > cap
    if case == "head_overflow_ties":
        # some overflowing tile has equal scores straddling the cap boundary
        zmin = verts[faces][..., 2].min(axis=1)
        ov = tr._face_tile_overlap(t(verts), t(faces), h, w, tile).numpy()
        straddle = 0
        for tile_ov in ov[counts.numpy() > cap]:
            z = np.sort(zmin[tile_ov])
            straddle += int(z[cap - 1] == z[cap])
        assert straddle > 0
    # batched binning equals frame-by-frame binning
    batched = tr._bin_faces(t(np.stack([verts, verts[::-1].copy()])), t(faces), h, w, tile, cap)[0]
    np.testing.assert_array_equal(batched[0].numpy(), ids.numpy())


def test_bin_overflow_and_auto_tile_match_jax():
    verts, faces = head_proxy_mesh()
    for tile, cap in ((56, 512), (32, 1024)):
        mx, frac = tr.bin_overflow(t(verts), t(faces), 224, 224, tile, cap)
        jmx, jfrac = jr.bin_overflow(jnp.asarray(verts), jnp.asarray(faces), 224, 224, tile, cap)
        assert int(mx) == int(jmx) and float(frac) == pytest.approx(float(jfrac))
    batch = np.stack([verts, verts * np.float32(0.5)])
    mx, frac = tr.bin_overflow(t(batch), t(faces), 224, 224, 56, 512)
    jmx, jfrac = jr.bin_overflow(jnp.asarray(batch), jnp.asarray(faces), 224, 224, 56, 512)
    assert int(mx) == int(jmx) and float(frac) == pytest.approx(float(jfrac))
    for args in ((224, 224, 9976), (256, 256, 9976), (224, 224, 70789), (112, 168, 100)):
        assert tr._auto_tile(*args) == jr._auto_tile(*args)


def _visibility_case(seed, n, cap, px_n, valid_share=0.8):
    """Random tiles with degenerate faces, exact duplicates (z ties) and
    sentinel slots."""
    rng = np.random.default_rng(seed)
    tri = rng.uniform(-1.0, 1.0, (n, cap, 9)).astype(np.float32)
    tri[:, ::7, 3:6] = tri[:, ::7, 0:3]  # degenerate: two equal corners
    tri[:, 1::5] = tri[:, 0:-1:5]  # exact duplicate of the previous slot
    valid = (rng.random((n, cap, 1)) < valid_share).astype(np.float32)
    px = rng.uniform(-1.0, 1.0, (n, px_n)).astype(np.float32)
    py = rng.uniform(-1.0, 1.0, (n, px_n)).astype(np.float32)
    return tri, valid, px, py


@pytest.mark.parametrize("n,cap,px_n,chunk", [(3, 64, 48, 32), (2, 128, 256, 128), (4, 32, 8, 32)])
def test_visibility_reference_matches_jax_interpret(n, cap, px_n, chunk):
    tri, valid, px, py = _visibility_case(n * cap + px_n, n, cap, px_n)
    jz, js = jras.rasterize_tiles_visibility(jnp.asarray(tri), jnp.asarray(valid), jnp.asarray(px),
                                             jnp.asarray(py), chunk=chunk, interpret=True)
    z, s = tras.rasterize_tiles_visibility(t(tri), t(valid), t(px), t(py), chunk=chunk)
    assert s.dtype == torch.int32 and z.dtype == torch.float32
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-6, rtol=0)
    assert (s >= 0).any() and (s < 0).any()
    # a duplicate (slot 5k+1) never wins over its valid first copy (5k)
    s = s.numpy()
    first_copy_valid = valid[np.arange(n)[:, None], np.maximum(s - 1, 0), 0] > 0
    assert not ((s % 5 == 1) & first_copy_valid).any()


def test_visibility_reference_ignores_chunking_and_handles_ragged_caps():
    tri, valid, px, py = _visibility_case(9, 3, 100, 37)
    ref = tras.rasterize_tiles_visibility_reference(t(tri), t(valid), t(px), t(py), chunk=100)
    for chunk in (1, 7, 64, 256):
        got = tras.rasterize_tiles_visibility_reference(t(tri), t(valid), t(px), t(py), chunk=chunk)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    empty = tras.rasterize_tiles_visibility_reference(t(tri), t(valid * 0), t(px), t(py))
    assert (empty[1] == -1).all() and (empty[0] == tras.BIG).all()


def test_visibility_wrapper_routes_cpu_to_plain_version():
    tri, valid, px, py = _visibility_case(10, 2, 64, 16)
    before = tras.launches
    got = tras.rasterize_tiles_visibility(t(tri), t(valid), t(px), t(py))
    ref = tras.rasterize_tiles_visibility_reference(t(tri), t(valid), t(px), t(py))
    assert torch.equal(got[1], ref[1]) and tras.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        tras.rasterize_tiles_visibility(t(tri).to("meta"), t(valid).to("meta"),
                                        t(px).to("meta"), t(py).to("meta"))


@pytest.mark.parametrize("per_corner", [False, True])
def test_kernel_route_matches_jax_pallas_and_binned(per_corner):
    """rasterize_binned_kernel (CPU: plain visibility) against JAX
    rasterize_binned_pallas(interpret=True) and rasterize_binned."""
    verts, faces, attrs = random_mesh(7, 60, 40)
    if per_corner:
        attrs = np.random.default_rng(8).standard_normal((40, 3, 4)).astype(np.float32)
    ji, jm = jr.rasterize_binned_pallas(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(attrs),
                                        32, 32, tile=16, cap=64, chunk=32, interpret=True,
                                        per_corner=per_corner)
    bi, bm = jr.rasterize_binned(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(attrs),
                                 32, 32, 16, 40, per_corner)
    ti, tm = tr.rasterize_binned_kernel(t(verts)[None], t(faces), t(attrs)[None], 32, 32,
                                        tile=16, cap=64, chunk=32, per_corner=per_corner)
    pi, pm = tr.rasterize_binned(t(verts), t(faces), t(attrs), 32, 32, 16, 40, per_corner)
    assert tm.any()
    for img, mask in ((ji, jm), (bi, bm)):
        np.testing.assert_array_equal(tm[0].numpy(), np.asarray(mask))
        assert_image(ti[0], img, rtol=1e-4)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(bm))
    assert_image(pi, bi)


def test_kernel_route_on_head_mesh_overflowing_matches_jax():
    """Two frames in one visibility call, tile 16 / cap 64 overflowing:
    each frame equals the JAX Pallas route (interpret) of that frame."""
    hv, faces = head_proxy_mesh()
    verts = np.stack([hv, hv * np.float32(1.1)])
    normals = tr.compute_vertex_normals(t(verts), t(faces))
    ti, tm = tr.rasterize_binned_kernel(t(verts), t(faces), normals, 64, 64, tile=16, cap=64,
                                        chunk=32)
    for b in range(2):
        ji, jm = jr.rasterize_binned_pallas(jnp.asarray(verts[b]), jnp.asarray(faces),
                                            jnp.asarray(normals[b].numpy()), 64, 64, tile=16,
                                            cap=64, chunk=32, interpret=True)
        np.testing.assert_array_equal(tm[b].numpy(), np.asarray(jm))
        assert_image(ti[b], ji, rtol=1e-4)


def test_rasterize_auto_backends_match_jax():
    rng = np.random.default_rng(5)
    verts = rng.uniform(-0.9, 0.9, (2, 50, 3)).astype(np.float32)
    faces = rng.integers(0, 50, (30, 3)).astype(np.int32)
    attrs = rng.standard_normal((2, 50, 3)).astype(np.float32)
    jd, jdm = jr.rasterize_auto(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(attrs), 32, 32)
    results = {
        backend: tr.rasterize_auto(t(verts), t(faces), t(attrs), 32, 32, tile=16, cap=32,
                                   backend=backend)
        for backend in (None, "dense", "binned", "kernel")
    }
    for backend, (img, mask) in results.items():
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jdm), err_msg=str(backend))
        assert_image(img, jd, rtol=1e-4)
    # shared (unbatched) attributes are broadcast over the frames
    shared, _ = tr.rasterize_auto(t(verts), t(faces), t(attrs[0]), 32, 32, backend="binned",
                                  tile=16, cap=32)
    jshared, _ = jr.rasterize_auto(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(attrs[0]),
                                   32, 32, tile=16, cap=32, backend="binned")
    assert_image(shared, jshared)
    with pytest.raises(ValueError, match="backend"):
        tr.rasterize_auto(t(verts), t(faces), t(attrs), 32, 32, backend="pallas")
