"""Port parity of the BFM09 / Deep3DFaceRecon path (``viz.bfm``): the
decode (shape, texture, Euler rotation, point_buf normals, SH lighting,
projection), ``render_bfm`` on a closed mesh of more than 4096 faces (so
the binned route at ``cap`` 4096 is the one compared, and the kernel
route's plain version beside it), ``Visualizer3dmmBfm``, ``BfmAssets.
from_mat`` on a ``.mat`` written by scipy, and ``D3dfrReconNet`` with its
importers, against the JAX package on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.viz import bfm as jbfm
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.infra.jax_params import d3dfr_state_from_jax
from avi_talking_tpu_torch.viz import bfm as tbfm
from avi_talking_tpu_torch.viz import rasterizer as tr
from _torch_threads import one_torch_thread  # noqa: F401


def _closed_mesh(n_lat=46, n_lon=46):
    """A closed ellipsoid (4232 faces at 46 x 46) and its per-vertex face
    lists padded with F."""
    i = np.arange(n_lat + 1)[:, None]
    j = np.arange(n_lon)[None, :]
    th, ph = np.pi * i / n_lat, 2 * np.pi * j / n_lon
    verts = np.stack(np.broadcast_arrays(0.24 * np.sin(th) * np.cos(ph), 0.3 * np.cos(th),
                                         0.21 * np.sin(th) * np.sin(ph)), -1).reshape(-1, 3)
    a = (i[:-1] * n_lon + j).reshape(-1)
    b = (i[:-1] * n_lon + (j + 1) % n_lon).reshape(-1)
    faces = np.stack([np.stack([a, b, a + n_lon], -1), np.stack([b, b + n_lon, a + n_lon], -1)],
                     axis=1).reshape(-1, 3)
    F, V = len(faces), len(verts)
    lists = [[] for _ in range(V)]
    for fi, f in enumerate(faces):
        for v in f:
            lists[v].append(fi)
    point_buf = np.full((V, max(len(x) for x in lists)), F, np.int64)
    for v, x in enumerate(lists):
        point_buf[v, :len(x)] = x
    return verts.astype(np.float32), faces.astype(np.int64), point_buf


def _assets():
    """BFM-width synthetic assets (id 80, exp 64, tex 80, 68 keypoints) on
    the closed mesh, as numpy arrays."""
    rng = np.random.default_rng(0)
    verts, faces, pbuf = _closed_mesh()
    V = len(verts)
    return dict(meanshape=verts.reshape(-1), id_base=rng.normal(0, 0.01, (3 * V, 80)),
                exp_base=rng.normal(0, 0.01, (3 * V, 64)),
                meantex=rng.uniform(80, 200, 3 * V), tex_base=rng.normal(0, 2, (3 * V, 80)),
                tri=faces, point_buf=pbuf, keypoints=rng.choice(V, 68, replace=False),
                skinmask=(rng.random(V) > 0.5))


def _port_assets(a):
    return tbfm.BfmAssets(**{k: torch.from_numpy(np.asarray(
        v, np.int64 if k in ("tri", "point_buf", "keypoints") else np.float32))
        for k, v in a.items()})


def _jax_assets(a):
    return jbfm.BfmAssets(**{k: jnp.asarray(
        v, jnp.int32 if k in ("tri", "point_buf", "keypoints") else jnp.float32)
        for k, v in a.items()})


def _coeffs(n, seed=1):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 0.5, (n, 257)).astype(np.float32)
    c[:, 224:227] = rng.uniform(-0.3, 0.3, (n, 3))  # Euler angles
    c[:, 227:254] = rng.normal(0, 0.1, (n, 27))  # SH gamma
    c[:, 254:257] = rng.normal(0, 0.05, (n, 3))  # translation
    return c


@pytest.fixture(scope="module")
def case():
    a = _assets()
    c = _coeffs(3)
    ja = _jax_assets(a)
    dec = jax.jit(lambda x, y: jbfm.bfm_decode(x, y))(ja, c)
    img, mask = jax.jit(lambda x, y: jbfm.render_bfm(x, y, 96))(ja, c[:2])
    return dict(a=a, c=c, ta=_port_assets(a), dec={k: np.asarray(v) for k, v in dec.items()},
                img=np.asarray(img), mask=np.asarray(mask))


def test_bfm_decode_matches_jax(case):
    got = tbfm.bfm_decode(case["ta"], torch.from_numpy(case["c"]))
    want = case["dec"]
    for k in ("vs", "vs_t"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["lms_proj"].numpy(), want["lms_proj"], atol=1e-3, rtol=1e-5)
    for k in ("texture", "color", "gray_color"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-3, rtol=1e-4)


def test_bfm_pieces_match_jax(case):
    c = torch.from_numpy(case["c"])
    parts = tbfm.split_coeffs(c)
    assert [p.shape[1] for p in parts] == [80, 64, 80, 3, 27, 3]
    assert torch.equal(tbfm.merge_coeffs(*parts), c)
    np.testing.assert_allclose(tbfm.euler_rotation(parts[3]).numpy(),
                               np.asarray(jbfm.euler_rotation(jnp.asarray(case["c"][:, 224:227]))),
                               atol=1e-6)
    vs = tbfm.bfm_shape(case["ta"], parts[0], parts[1])
    np.testing.assert_allclose(
        tbfm.bfm_vertex_normals(case["ta"], vs).numpy(),
        np.asarray(jbfm.bfm_vertex_normals(_jax_assets(case["a"]), jnp.asarray(vs.numpy()))),
        atol=1e-5)
    n = torch.nn.functional.normalize(torch.randn(4, 3, generator=torch.Generator().manual_seed(2)))
    np.testing.assert_allclose(tbfm.bfm_sh_basis(n).numpy(),
                               np.asarray(jbfm.bfm_sh_basis(jnp.asarray(n.numpy()))), atol=1e-6)


def test_render_bfm_binned_matches_jax(case):
    """The binned route at cap 4096 (4232 faces, 96^2, tile 32) against
    JAX's: masks equal, colours within 1e-3 (of 255) but at pixels whose
    winning face changes with rounding (counted); then the kernel route's
    plain version (K2's CPU path) against the binned route."""
    c = torch.from_numpy(case["c"][:2])
    assert case["ta"].tri.shape[0] >= 4096
    img, mask = tbfm.render_bfm(case["ta"], c, 96)
    assert img.shape == (2, 96, 96, 3) and mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), case["mask"])
    assert 0.2 < mask.float().mean() < 0.8
    d = np.abs(img.numpy() - case["img"]).max(-1)
    print(f"render_bfm: {int((d > 1e-3).sum())} of {int(mask.sum())} covered pixels differ")
    assert (d > 1e-3).mean() < 2e-3 and d.max() <= 255
    out = tbfm.bfm_decode(case["ta"], c, tbfm.D3DFR_DEFAULT_FOCAL, 96)
    ndc = torch.cat([2.0 * tbfm.project_vs(out["vs_t"], tbfm.D3DFR_DEFAULT_FOCAL, 96) / 96 - 1.0,
                     (10.0 - out["vs_t"][..., 2])[..., None]], -1)
    k_img, k_mask = tr.rasterize_auto(ndc, case["ta"].tri, out["color"], 96, 96, cap=4096,
                                      backend="kernel")
    assert torch.equal(k_mask, mask)
    assert float((k_img.clamp(0, 255) - img).abs().max(-1).values.gt(1e-3).float().mean()) < 2e-3


def test_visualizer_renders_frames(case):
    viz = tbfm.Visualizer3dmmBfm(case["ta"], img_size=96)
    jviz = jbfm.Visualizer3dmmBfm(_jax_assets(case["a"]), img_size=96)
    got = viz(torch.from_numpy(case["c"][2:]))
    want = np.asarray(jviz(jnp.asarray(case["c"][2:])))
    assert got.shape == (1, 96, 96, 3) and viz.focal == jviz.focal
    assert float(got.amax(-1).gt(0).float().mean()) > 0.05
    assert (np.abs(got.numpy() - want).max(-1) > 1e-3).mean() < 2e-3


def test_from_mat_matches_jax(case, tmp_path):
    """A BFM09_model_info.mat as scipy writes one (1-based indices)."""
    from scipy.io import savemat

    a = case["a"]
    path = str(tmp_path / "BFM09_model_info.mat")
    savemat(path, {"meanshape": a["meanshape"][None].astype(np.float32),
                   "idBase": a["id_base"].astype(np.float32),
                   "exBase": a["exp_base"].astype(np.float32),
                   "meantex": a["meantex"][None].astype(np.float32),
                   "texBase": a["tex_base"].astype(np.float32), "tri": a["tri"] + 1,
                   "point_buf": a["point_buf"] + 1, "keypoints": a["keypoints"][None] + 1,
                   "skinmask": a["skinmask"][None].astype(np.float32)})
    got, want = tbfm.BfmAssets.from_mat(path), jbfm.BfmAssets.from_mat(path)
    for k in ("meanshape", "id_base", "exp_base", "meantex", "tex_base", "tri", "point_buf",
              "keypoints", "skinmask"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    assert got.num_vertices == want.num_vertices
    np.testing.assert_array_equal(got.tri.numpy(), a["tri"])


@pytest.fixture(scope="module")
def recon():
    """A seeded D3dfrReconNet with random heads (the zero init would make
    the comparison empty) and JAX's output through JAX's importer."""
    net = random_module(tbfm.D3dfrReconNet, torch.device("cpu"), torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for h in net.final_layers:
            assert float(h.weight.abs().max()) == 0.0  # ReconNetWrapper's zero init
            h.weight.copy_(torch.randn(h.weight.shape, generator=g) * 0.02)
            h.bias.copy_(torch.randn(h.bias.shape, generator=g))
    sd = {"net." + k: v.numpy() for k, v in net.state_dict().items()}
    jvars = jbfm.d3dfr_params_from_torch(sd, prefix="net.")
    x = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, y: jbfm.D3dfrReconNet().apply(v, y))(jvars, x))
    return net, sd, jvars, x, want


def test_d3dfr_recon_net_matches_jax(recon):
    net, _, _, x, want = recon
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 257)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_d3dfr_importers_round_trip(recon):
    net, sd, jvars, _, _ = recon
    for got in (tbfm.d3dfr_state_from_torch(sd, prefix="net."), d3dfr_state_from_jax(jvars)):
        want = net.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v.numpy(), err_msg=k)
    nofc = {k.replace("final_layers", "fianl_layers"): v for k, v in sd.items()}
    got = tbfm.d3dfr_state_from_torch(nofc, prefix="net.", heads_key="fianl_layers")
    np.testing.assert_array_equal(got["final_layers.6.bias"], sd["net.final_layers.6.bias"])
