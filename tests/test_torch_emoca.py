"""Port parity of the EMOCA / DECA modules: the encoders and their
reference importers, ``emoca_pseudo_gt``, ``FlameTex``, the OBJ reader,
``render_textured`` / ``render_detailed`` (per-corner, against JAX's binned
route, and K2's route), ``DetailGenerator`` and its importer, ``world2uv``
/ ``detail_normals``, the DECA losses, and the frozen towers' checkpoint
reader (``infra.checkpoint.load_frozen_tower``: extra keys and non-tensor
entries read as JAX reads them, a missing key named).

The port's seeded weights go to JAX through JAX's own reference importers,
so no flax init is compiled here."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.core import flame as jflame
from avi_talking_tpu.models import deca_detail as jdd
from avi_talking_tpu.models import emoca as jemoca
from avi_talking_tpu.train import deca_losses as jdl
from avi_talking_tpu.viz import meshio as jmeshio
from avi_talking_tpu.viz import rasterizer as jr
from avi_talking_tpu.viz import shading as jsh
from avi_talking_tpu_torch.core.flame import FlameTex
from avi_talking_tpu_torch.infra.checkpoint import load_frozen_tower
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.infra.jax_params import (detail_generator_state_from_jax,
                                                    emoca_encoder_state_from_jax)
from avi_talking_tpu_torch.models import deca_detail as tdd
from avi_talking_tpu_torch.models import emoca as temoca
from avi_talking_tpu_torch.models.fan_encoder import FanEncoder
from avi_talking_tpu_torch.train import deca_losses as tdl
from avi_talking_tpu_torch.viz import meshio as tmeshio
from avi_talking_tpu_torch.viz import rasterizer as tr
from avi_talking_tpu_torch.viz import shading as tsh
from _torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(0)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np_state(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _perturb_norms(module, seed):
    """Random BatchNorm affine and running statistics, so that a parity
    test reaches them (a fresh init has mean 0, var 1, weight 1, bias 0)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=g) * 0.5 + 0.75)
                m.weight.copy_(torch.rand(n, generator=g) * 0.5 + 0.75)
                m.bias.copy_(torch.randn(n, generator=g) * 0.1)
    return module


# ------------------------------------------------------------- encoders --


@pytest.fixture(scope="module")
def encoder_case():
    """A seeded port EmocaEncoder (n_exp 6, detail 4), its reference state
    dict under a ``deca.`` prefix with one extra key, and JAX's codes from
    JAX's importer on that state dict."""
    enc = _perturb_norms(random_module(
        lambda: temoca.EmocaEncoder(n_exp=6, with_detail=True, n_detail=4), torch.device("cpu"),
        torch.Generator().manual_seed(3)), 4)
    sd = {"deca." + k: v for k, v in _np_state(enc).items()}
    sd["deca.E_flame.encoder.fc.weight"] = np.zeros((3, 3), np.float32)  # not the module's
    jvars = jemoca.emoca_encoder_params_from_torch(sd, prefix="deca.", with_detail=True)
    x = RNG.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jmod = jemoca.EmocaEncoder(n_exp=6, with_detail=True, n_detail=4)
    jcodes = jax.jit(lambda v, a: jmod.apply(v, a))(jvars, jnp.asarray(x))
    return enc, sd, jvars, x, {k: np.asarray(v) for k, v in jcodes.items()}


def test_emoca_encoder_matches_jax(encoder_case):
    enc, _, _, x, jcodes = encoder_case
    with torch.no_grad():
        codes = enc(_t(x).permute(0, 3, 1, 2))
    assert set(codes) == set(jcodes)
    for k, v in jcodes.items():
        np.testing.assert_allclose(codes[k].numpy(), v, rtol=1e-3, atol=1e-3, err_msg=k)


def test_encoder_importers_match_jax(encoder_case):
    """``emoca_encoder_state_from_torch`` takes the module's own keys out
    of the reference file (the extra key left out) and loads with
    ``load_state_dict``; it equals JAX's importer carried by
    ``emoca_encoder_state_from_jax``; ``deca_encoder_state_from_torch``
    reads one tower."""
    enc, sd, jvars, _, _ = encoder_case
    got = temoca.emoca_encoder_state_from_torch(sd, "deca.", with_detail=True)
    with torch.device("meta"):
        fresh = temoca.EmocaEncoder(n_exp=6, with_detail=True, n_detail=4)
    fresh = fresh.to_empty(device="cpu")
    fresh.load_state_dict(got)
    ref = emoca_encoder_state_from_jax(jax.tree.map(np.asarray, jvars))
    assert set(ref) == set(got)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    tower = temoca.deca_encoder_state_from_torch(sd, "deca.E_expression.")
    assert tower["layers.2.weight"].shape == (6, 1024)
    with pytest.raises(RuntimeError, match="E_detail.layers.0.bias"):
        temoca.emoca_encoder_state_from_torch(
            {k: v for k, v in sd.items() if k != "deca.E_detail.layers.0.bias"}, "deca.",
            with_detail=True)


def test_split_and_pseudo_gt_match_jax():
    code = RNG.standard_normal((5, 236)).astype(np.float32)
    jparts = jemoca.split_deca_code(jnp.asarray(code))
    tparts = temoca.split_deca_code(_t(code))
    for k in jparts:
        np.testing.assert_array_equal(tparts[k].numpy(), np.asarray(jparts[k]))
    vis = np.asarray([1, 0, 1, 1, 0], np.float32)
    for validity in (None, vis):
        j = jemoca.emoca_pseudo_gt(jparts, None if validity is None else jnp.asarray(validity))
        t = temoca.emoca_pseudo_gt(tparts, None if validity is None else _t(validity))
        for k in j:
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-6, atol=1e-6)


# -------------------------------------------------- texture, OBJ reader --


def test_flame_tex_matches_jax(tmp_path):
    side, n = 8, 12
    mean = RNG.uniform(0, 255, (side * side * 3,)).astype(np.float32)
    basis = RNG.standard_normal((side, side, 3, n)).astype(np.float32) * 40
    for key in ("tex_dir", "basis"):
        path = str(tmp_path / f"tex_{key}.npz")
        np.savez(path, mean=mean, **{key: basis})
        code = RNG.standard_normal((2, 5)).astype(np.float32)
        want = np.asarray(jflame.FlameTex.from_npz(path, n_tex=5)(jnp.asarray(code)))
        got = FlameTex.from_npz(path, n_tex=5)(_t(code)).numpy()
        assert got.shape == (2, side, side, 3)
        assert got.min() >= 0 and got.max() <= 1 and (got == 1).any() and (got == 0).any()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_obj_roundtrip_matches_jax(tmp_path):
    v = RNG.standard_normal((6, 3)).astype(np.float32)
    f = np.asarray([[0, 1, 2], [2, 3, 4], [3, 4, 5]], np.int32)
    uv = RNG.uniform(0, 1, (7, 2)).astype(np.float32)
    fuv = np.asarray([[0, 1, 2], [3, 4, 5], [6, 5, 4]], np.int32)
    path = str(tmp_path / "m.obj")
    tmeshio.Mesh(v, f, uv, fuv).save(path)
    j, t = jmeshio.read_obj(path), tmeshio.read_obj(path)
    for name in ("vertices", "faces", "uvs", "face_uvs"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    ply_t, ply_j = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    tmeshio.write_ply(ply_t, v, f)
    jmeshio.write_ply(ply_j, v, f)
    assert open(ply_t, "rb").read() == open(ply_j, "rb").read()


# -------------------------------------------------------------- renders --


def _grid_mesh(n=47, seed=0):
    """An n x n vertex grid over the image (2 (n-1)^2 faces, 4232 at 47:
    past the binned routes' 4096), with a z bump; UVs from the grid."""
    ys, xs = np.mgrid[0:n, 0:n].astype(np.float32) / (n - 1)
    z = 0.3 * np.exp(-((xs - 0.5) ** 2 + (ys - 0.5) ** 2) / 0.05)
    r = np.random.default_rng(seed)
    base = np.stack([xs * 1.8 - 0.9, ys * 1.8 - 0.9, -z], -1).reshape(-1, 3)
    verts = np.stack([base + r.normal(0, 0.004, base.shape) for _ in range(2)]).astype(np.float32)
    uv = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    return verts, jdd.grid_faces(n, n), uv


@pytest.fixture(scope="module")
def render_case():
    verts, faces, uv = _grid_mesh()
    tex = RNG.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    nmap = RNG.standard_normal((2, 12, 12, 3)).astype(np.float32)
    light = (RNG.standard_normal((2, 9, 3)) * 0.3).astype(np.float32)
    light[:, 0] += 2.5
    S = 96
    jv, jf, ju, jl = map(jnp.asarray, (verts, faces, uv, light))
    jt_img, jt_aux = jax.jit(lambda v, t, l: jsh.render_textured(
        v, jf, ju, jf, t, S, S, sh_coeff=l, return_aux=True))(jv, jnp.asarray(tex), jl)
    jd_img = jax.jit(lambda v, t, n, l: jsh.render_detailed(
        v, jf, ju, jf, t, n, S, S, sh_coeff=l))(jv, jnp.asarray(tex), jnp.asarray(nmap), jl)
    return dict(verts=verts, faces=faces, uv=uv, tex=tex, nmap=nmap, light=light, S=S,
                textured=np.asarray(jt_img), aux={k: np.asarray(v) for k, v in jt_aux.items()},
                detailed=np.asarray(jd_img))


def test_render_textured_matches_jax_binned(render_case):
    c = render_case
    f = _t(c["faces"])
    img, aux = tsh.render_textured(_t(c["verts"]), f, _t(c["uv"]), f, _t(c["tex"]), c["S"], c["S"],
                                   sh_coeff=_t(c["light"]), return_aux=True)
    assert c["aux"]["alpha_images"].mean() > 0.5
    np.testing.assert_array_equal(aux["alpha_images"].numpy(), c["aux"]["alpha_images"])
    np.testing.assert_allclose(img.numpy(), c["textured"], atol=2e-5)
    for k in ("shading", "albedo_images", "normal_images"):
        np.testing.assert_allclose(aux[k].numpy(), c["aux"][k], atol=5e-5, err_msg=k)


def test_render_detailed_matches_jax_binned(render_case):
    c = render_case
    f = _t(c["faces"])
    img = tsh.render_detailed(_t(c["verts"]), f, _t(c["uv"]), f, _t(c["tex"]), _t(c["nmap"]),
                              c["S"], c["S"], sh_coeff=_t(c["light"]))
    np.testing.assert_allclose(img.numpy(), c["detailed"], atol=2e-5)


@pytest.mark.parametrize("channels", [5, 2])
def test_per_corner_kernel_route_matches_jax_binned(render_case, channels):
    """The renders' per-corner rasterization through K2's route (the CUDA
    path; its plain version here) against JAX's binned rasterizer, with the
    gradient to the corner attributes: the textured render's 5 channels
    [u v n] and the detail render's 2 [u v]. Held at the JAX suite's
    Pallas-against-XLA tolerance (rtol 1e-3, atol 1e-4): the attributes are
    random per corner, so the few pixels whose barycentrics round apart
    differ by more than the renders' 2e-5."""
    c = render_case
    S, faces = c["S"], c["faces"]
    attrs = RNG.standard_normal((2, faces.shape[0], 3, channels)).astype(np.float32)
    w = RNG.standard_normal((2, S, S, channels)).astype(np.float32)

    def jloss(a):
        img, _ = jr.rasterize_auto(jnp.asarray(c["verts"]), jnp.asarray(faces), a, S, S,
                                   per_corner=True)
        return jnp.sum(img * w), img

    (_, jimg), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(attrs))
    ta = _t(attrs).requires_grad_()
    img, mask = tr.rasterize_auto(_t(c["verts"]), _t(faces), ta, S, S, per_corner=True,
                                  backend="kernel")
    (img * _t(w)).sum().backward()
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jgrad), rtol=1e-3, atol=1e-4)
    assert mask.float().mean() > 0.5


# ---------------------------------------------------------- detail branch --


@pytest.fixture(scope="module")
def generator_case():
    gen = _perturb_norms(tdd.DetailGenerator.random_init(16, init_size=8, seed=5, device="cpu"),
                         6)
    sd = {"D_detail." + k: v for k, v in _np_state(gen).items()}
    jvars = jdd.detail_generator_params_from_torch(sd, prefix="D_detail.")
    z = RNG.standard_normal((2, 16)).astype(np.float32)
    out = jax.jit(lambda v, a: jdd.DetailGenerator(latent_dim=16).apply(v, a))(jvars,
                                                                            jnp.asarray(z))
    return gen, sd, jvars, z, np.asarray(out)


def test_detail_generator_matches_jax(generator_case):
    gen, _, _, z, want = generator_case
    with torch.no_grad():
        got = gen(_t(z)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 256, 256, 1)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-3)


def test_detail_generator_importers(generator_case):
    _, sd, jvars, _, _ = generator_case
    got = tdd.detail_generator_state_from_torch(sd, "D_detail.")
    ref = detail_generator_state_from_jax(jax.tree.map(np.asarray, jvars))
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    fresh = tdd.DetailGenerator.random_init(16, init_size=8, seed=0, device="cpu")
    fresh.load_state_dict(got)
    assert fresh.conv_blocks[3].eps == 0.8 and fresh.conv_blocks[0].eps == 1e-5


def test_world2uv_and_detail_normals_match_jax():
    """world2uv on the tiny FLAME (its planar UVs overlap, so the first
    face decides) and on the bumpy grid (every UV pixel covered), then the
    grid's detail normals; frame by frame in JAX against the port's batched
    calls."""
    from avi_talking_tpu.core import synthetic_assets

    assets = synthetic_assets(n_shape=8, n_exp=6)
    t = np.asarray(assets.v_template)
    uv_t = ((t - t.min(0)) / (t.max(0) - t.min(0) + 1e-6))[:, :2].astype(np.float32)
    f_t = np.asarray(assets.faces)
    v_t = (t[None] + RNG.normal(0, 0.01, (2,) + t.shape)).astype(np.float32)
    v_g, f_g, uv_g = _grid_mesh(9)
    S = 24
    disp = (RNG.standard_normal((2, S, S, 1)) * 0.01).astype(np.float32)
    mask = (RNG.uniform(0, 1, (S, S, 1)) > 0.3).astype(np.float32)

    def jgeom(v, f, uv):
        f, uv = jnp.asarray(f), jnp.asarray(uv)

        def one(vv):
            vn = jr.compute_vertex_normals(vv[None], f)[0]
            return jdd.world2uv(vv, f, uv, f, S), jdd.world2uv(vn, f, uv, f, S)
        return jax.jit(jax.vmap(one))(jnp.asarray(v))

    for v, f, uv in ((v_t, f_t, uv_t), (v_g, f_g, uv_g)):
        jv, jn = jgeom(v, f, uv)
        dm = tdd.DecaDetailModel(generator=None, faces=_t(f), uv_coords=_t(uv), uv_faces=_t(f),
                                 uv_size=S)
        tv, tn = dm.uv_geometry(_t(v))
        assert (np.abs(np.asarray(jv)).sum(-1) > 0).mean() > 0.2
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6)
    jd = jax.jit(jax.vmap(lambda a, b, d: jdd.detail_normals(a, b, d, jnp.asarray(mask))))(
        jv, jn, jnp.asarray(disp))
    td = tdd.detail_normals(tv, tn, _t(disp), _t(mask))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)


# ----------------------------------------------------------------- losses --


def _nhwc(shape, lo=0.0, hi=1.0):
    return RNG.uniform(lo, hi, shape).astype(np.float32)


def test_simple_losses_match_jax():
    x, y = _nhwc((2, 9, 9, 3), 0.05, 1.4), _nhwc((2, 9, 9, 3))
    m = (RNG.uniform(0, 1, (2, 9, 9, 1)) > 0.4).astype(np.float32)
    cases = [
        ("shading_white_loss", (x,), 1e-6),
        ("shading_smooth_loss", (x,), 1e-6),
        ("albedo_constancy_loss", (x,), 1e-6),
        ("z_reg", (x,), 1e-6),
        ("light_reg", (RNG.standard_normal((2, 9, 3)).astype(np.float32),), 1e-7),
        ("shape_reg", (RNG.standard_normal((2, 100)).astype(np.float32),), 1e-3),
        ("kl_loss", (RNG.standard_normal((4, 256)).astype(np.float32),), 1e-3),
        ("z_symmetry_loss", (x[..., :1], m), 1e-4),
        ("binary_erosion_mask", ((RNG.uniform(0, 1, (2, 12, 12, 1)) > 0.2)
                                 .astype(np.float32),), 0.0),
    ]
    for mode in ("mean", "rel_mask_value", "inv_rel_mask_value", "abs_mask_value"):
        got = tdl.photometric_loss(_t(x), _t(y), _t(m), mode)
        want = jdl.photometric_loss(jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), mode)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6, err_msg=mode)
    for name, args, tol in cases:
        got = getattr(tdl, name)(*map(_t, args))
        want = getattr(jdl, name)(*map(jnp.asarray, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=1e-6,
                                   err_msg=name)
    with pytest.raises(ValueError, match="VAE"):
        tdl.kl_loss(_t(RNG.standard_normal((2, 50)).astype(np.float32)))


def test_landmark_and_ring_losses_match_jax():
    pred = RNG.standard_normal((3, 68, 2)).astype(np.float32)
    gt = RNG.standard_normal((3, 68, 2)).astype(np.float32)
    for name in ("deca_landmark_loss", "deca_weighted_landmark_loss"):
        got = getattr(tdl, name)(_t(pred), _t(gt))
        want = getattr(jdl, name)(jnp.asarray(pred), jnp.asarray(gt))
        assert abs(float(got) - float(want)) < 1e-6, name
    for ring_type, R in (("51", 7), ("33", 6)):
        ring = (RNG.standard_normal((R, 4, 16)) * 0.3).astype(np.float32)
        got = tdl.ring_loss(_t(ring), ring_type, margin=0.5)
        assert abs(float(got) - float(jdl.ring_loss(jnp.asarray(ring), ring_type, 0.5))) < 1e-5
    ring = RNG.standard_normal((4, 3, 8)).astype(np.float32)
    assert abs(float(tdl.albedo_ring_loss(_t(ring), 0.1))
               - float(jdl.albedo_ring_loss(jnp.asarray(ring), 0.1))) < 1e-6
    assert abs(float(tdl.albedo_same_loss(_t(ring)))
               - float(jdl.albedo_same_loss(jnp.asarray(ring)))) < 1e-6


def test_idmrf_and_patch_losses_match_jax():
    """IDMRF on NCHW features against JAX's on NHWC, and the detail patch
    losses where the patches shrink (0.7 x 64 -> 32: ``jax.image.resize``
    antialiases, which ``F.interpolate`` would not)."""
    fg = {"relu_3_2": _nhwc((2, 7, 5, 5)), "relu_4_2": _nhwc((2, 6, 3, 3))}
    ft = {"relu_3_2": _nhwc((2, 7, 5, 5)), "relu_4_2": _nhwc((2, 6, 3, 3))}
    got = tdl.IDMRFLoss()({k: _t(v) for k, v in fg.items()}, {k: _t(v) for k, v in ft.items()})
    want = jdl.IDMRFLoss()({k: jnp.asarray(v.transpose(0, 2, 3, 1)) for k, v in fg.items()},
                           {k: jnp.asarray(v.transpose(0, 2, 3, 1)) for k, v in ft.items()})
    assert abs(float(got) - float(want)) < 5e-4

    tex, gt = _nhwc((2, 64, 64, 3)), _nhwc((2, 64, 64, 3))
    vis = (RNG.uniform(0, 1, (2, 64, 64, 1)) > 0.3).astype(np.float32)
    want = jdl.detail_patch_losses(jnp.asarray(tex), jnp.asarray(gt), jnp.asarray(vis),
                                   sfsw=(5.0, 1.0, 0.0), patch_size=32)
    got = tdl.detail_patch_losses(_t(tex), _t(gt), _t(vis), sfsw=(5.0, 1.0, 0.0), patch_size=32)
    assert set(got) == set(want) == {"detail_l1_0", "detail_l1_1"}
    for k in want:
        assert abs(float(got[k]) - float(want[k])) < 1e-6, k


def test_coarse_losses_match_jax():
    B, H = 2, 8
    cd = {
        "predicted_landmarks": RNG.standard_normal((B, 68, 2)),
        "lmk": RNG.standard_normal((B, 68, 2)),
        "predicted_images": RNG.uniform(0, 1, (B, H, H, 3)),
        "images": RNG.uniform(0, 1, (B, H, H, 3)),
        "masks": (RNG.uniform(0, 1, (B, H, H, 1)) > 0.3),
        "shading": RNG.uniform(0, 2, (B, H, H, 3)),
        "albedo": RNG.uniform(0, 1, (B, 4, 4, 3)),
        "shapecode": RNG.standard_normal((B, 10)),
        "expcode": RNG.standard_normal((B, 6)),
        "texcode": RNG.standard_normal((B, 5)),
        "lightcode": RNG.standard_normal((B, 9, 3)),
    }
    cd = {k: np.asarray(v, np.float32) for k, v in cd.items()}
    w = jdl.DecaLossWeights(mouth_corner=0.5)
    want = jdl.coarse_losses({k: jnp.asarray(v) for k, v in cd.items()}, w)
    got = tdl.coarse_losses({k: _t(v) for k, v in cd.items()},
                            tdl.DecaLossWeights(mouth_corner=0.5))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# ------------------------------------ the frozen towers' checkpoint reader --


def _towers():
    cpu = torch.device("cpu")
    return {
        "fan": lambda: FanEncoder.random_init(64, seed=1, device="cpu"),
        "emonet": lambda: random_module(lambda: temoca.EmotionRecognitionModule(8), cpu,
                                        torch.Generator().manual_seed(4)),
    }


@pytest.mark.parametrize("tower", ["fan", "emonet"])
@pytest.mark.parametrize("layout", ["extra_key", "lightning_hparams", "missing_key"])
def test_frozen_tower_reader(tower, layout, tmp_path):
    """``load_frozen_tower`` (``train-faceformer --fan-checkpoint`` /
    ``--emonet-checkpoint``, ``train-faceformer-vert --fan-checkpoint``,
    ``train-emoca --emonet-checkpoint``) reads as JAX's importers do: a
    state dict with a key the module lacks, and a Lightning file whose
    ``hyper_parameters`` are no tensor (``weights_only`` refuses it), load;
    a missing key raises and names it."""
    src = _towers()[tower]()
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.01)
    sd = dict(src.state_dict())
    path = str(tmp_path / "tower.pt")
    if layout == "extra_key":
        sd["head.extra.weight"] = torch.zeros(2)
        torch.save(sd, path)
    elif layout == "lightning_hparams":
        torch.save({"state_dict": sd, "hyper_parameters": argparse.Namespace(lr=1e-4)}, path)
        with pytest.raises(Exception):
            torch.load(path, weights_only=True)
    else:
        gone = next(k for k in sd if k.endswith(".bias"))
        sd.pop(gone)
        torch.save({"state_dict": sd}, path)
        with pytest.raises(RuntimeError, match=gone.replace(".", r"\.")):
            load_frozen_tower(_towers()[tower](), path)
        return
    dst = load_frozen_tower(_towers()[tower](), path)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


def test_train_faceformer_fan_reader_reads_a_lightning_file(tmp_path):
    """``train-faceformer --fan-checkpoint``'s reader (``cli.train.
    frozen_fan``) takes a Lightning file with a non-tensor
    ``hyper_parameters`` and a key the tower lacks."""
    from avi_talking_tpu_torch.cli.train import frozen_fan

    src = _towers()["fan"]()
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.01)
    path = str(tmp_path / "fan.ckpt")
    torch.save({"state_dict": dict(src.state_dict(), **{"extra.weight": torch.zeros(1)}),
                "hyper_parameters": argparse.Namespace(size=64)}, path)
    fan = frozen_fan(argparse.Namespace(fan_checkpoint=path), 64, torch.device("cpu"))
    for k, v in src.state_dict().items():
        assert torch.equal(fan.state_dict()[k], v), k
