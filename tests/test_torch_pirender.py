"""Port parity of PIRender and the portrait command: the bilinear resize at
its four uses, the generator's layers and the whole ``FaceGenerator`` (fp32
at the JAX suite's rtol 1e-4 / atol 1e-5; bf16 by ``assert_closer``'s
rule against JAX compiled without excess precision), the reference
``net_G`` import, ``pipeline/portrait.py`` (bit-equal; the renderer at
2e-5), the golden ``tiny_portrait.json`` and ``portrait --tiny --device
cpu``; weights carried from the JAX modules by ``infra.jax_params``."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from avi_talking_tpu.models import pirender as jp
from avi_talking_tpu.pipeline import portrait as jportrait
from avi_talking_tpu_torch.cli import main
from avi_talking_tpu_torch.infra.jax_params import pirender_state_from_jax
from avi_talking_tpu_torch.models import pirender as tp
from avi_talking_tpu_torch.ops.layers import set_compute_dtype
from avi_talking_tpu_torch.ops.resize import resize_bilinear, resize_image_hwc
from avi_talking_tpu_torch.pipeline import portrait as tportrait
from avi_talking_tpu_torch.viz.pngio import read_png, write_png
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bf16 import assert_closer, exact_jit

TOL = dict(rtol=1e-4, atol=1e-5)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_portrait.json")
S = 32  # image side of the generator cases


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _port(cfg, variables, dtype=torch.float32):
    gen = tp.FaceGenerator(tp.PIRenderConfig(**dataclasses.asdict(cfg)), dtype=dtype)
    gen.load_state_dict({k: torch.from_numpy(v) for k, v in
                         pirender_state_from_jax(_np(variables)).items()})
    return gen.eval()


@pytest.fixture(scope="module")
def jax_side():
    """The tiny generator's variables and JAX's outputs, fp32 and bf16
    (excess precision off). The weights are the port's seeded ones with
    biases and norms moved off their init, carried to JAX by its reference
    importer (flax's own init of the generator compiles for about 15 s)."""
    cfg = jp.PIRenderConfig.tiny()
    rng = np.random.default_rng(2)
    img = rng.uniform(-1, 1, (2, S, S, 3)).astype(np.float32)
    coeff = rng.standard_normal((2, 27, cfg.coeff_nc)).astype(np.float32)
    gen = jp.FaceGenerator(cfg)
    g = torch.Generator().manual_seed(3)
    state = {k: v + 0.02 * torch.randn(v.shape, generator=g) for k, v in tp.FaceGenerator.random_init(
        tp.PIRenderConfig.tiny(), seed=0, device="cpu").state_dict().items()}
    variables = _np(jp.pirender_params_from_torch(state, cfg))
    return {
        "cfg": cfg, "img": img, "coeff": coeff, "variables": variables,
        "f32": _np(jax.jit(gen.apply)(variables, img, coeff)),
        "bf16": _np(exact_jit(jp.FaceGenerator(cfg, dtype=jnp.bfloat16).apply, variables, img,
                              coeff)),
    }


# ------------------------------------------------------------- resize --


@pytest.mark.parametrize("shape,size", [
    ((2, 16, 16, 2), (64, 64)),    # the deformation's upsample (64 -> 256 at full size)
    ((1, 40, 36, 3), (32, 32)),    # cmd_portrait's source, shrunk
    ((1, 20, 24, 3), (32, 32)),    # ... and grown
    ((2, 32, 32, 3), (16, 16)),    # the perceptual pyramid's halving
    ((2, 15, 15, 3), (7, 7)),      # ... at an odd side
    ((1, 64, 64, 3), (32, 32)),    # VideoPairDataset._image
])
def test_resize_matches_jax_image_resize(shape, size):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0], *size, shape[3]), "bilinear"))
    got = _nhwc(resize_bilinear(_nchw(x), size))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    if shape[0] == 1:
        np.testing.assert_allclose(resize_image_hwc(x[0], size[0]), ref[0], rtol=0, atol=2e-6)
    if size[0] < shape[1]:  # shrinking: torch's bilinear without antialias is not JAX's
        plain = F.interpolate(_nchw(x), size=size, mode="bilinear", align_corners=False)
        assert np.abs(_nhwc(plain) - ref).max() > 0.05


def test_resize_bf16_matches_jax():
    """The deformation's upsample at bf16: the weights cast to bf16, each
    contraction rounded, as JAX's einsum."""
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 2)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x, jnp.bfloat16), (2, 64, 64, 2), "bilinear"),
                     np.float32)
    got = _nhwc(resize_bilinear(_nchw(x).to(torch.bfloat16), (64, 64)))
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------- layers --


def test_layernorm2d_and_adain_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 6, 5, 8)) * 2 + 0.3).astype(np.float32)
    z = rng.standard_normal((2, 16)).astype(np.float32)
    ln = jp.LayerNorm2d(8)
    lv = jax.tree.map(lambda a: a + np.float32(0.3), ln.init(jax.random.PRNGKey(0), x))
    tln = tp.LayerNorm2d(8)
    tln.load_state_dict({k: torch.tensor(np.asarray(lv["params"][k]))[:, None, None]
                         for k in ("weight", "bias")})
    ad = jp.Adain(8)
    av = ad.init(jax.random.PRNGKey(1), x, z)
    tad = tp.Adain(8, 16)
    p = _np(av["params"])
    tad.load_state_dict({f"{name}.{k}": torch.from_numpy(np.ascontiguousarray(
        p[key]["kernel"].T if k == "weight" else p[key]["bias"]))
        for key, name in (("mlp_shared", "mlp_shared.0"), ("mlp_gamma", "mlp_gamma"),
                          ("mlp_beta", "mlp_beta")) for k in ("weight", "bias")})
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(tln(_nchw(x))), ln.apply(lv, x), **TOL)
        np.testing.assert_allclose(_nhwc(tad(_nchw(x), torch.from_numpy(z))), ad.apply(av, x, z),
                                   **TOL)
        # bf16: LayerNorm2d's output is float32 (its float32 affine), Adain's bf16
        xb = jnp.asarray(x, jnp.bfloat16)
        ref_ln = exact_jit(ln.apply, lv, xb)
        got_ln = tln(_nchw(x).to(torch.bfloat16))
        assert ref_ln.dtype == jnp.float32 and got_ln.dtype == torch.float32
        np.testing.assert_allclose(_nhwc(got_ln), np.asarray(ref_ln), rtol=0, atol=1e-6)
        ref_ad = exact_jit(jp.Adain(8, jnp.bfloat16).apply, av, xb, z)
        got_ad = set_compute_dtype(tad, torch.bfloat16)(_nchw(x).to(torch.bfloat16),
                                                         torch.from_numpy(z))
        assert got_ad.dtype == torch.bfloat16
        np.testing.assert_array_equal(_nhwc(got_ad), np.asarray(ref_ad, np.float32))


def test_conv_t2x_and_mapping_net_match_jax():
    """flax's ConvTranspose(((1, 2), (1, 2)), transpose_kernel) as torch's
    ConvTranspose2d(3, 2, 1, 1), and MappingNet (VALID, dilation 3, the
    [3:-3] residual, the mean), fp32 and bf16 (bit-equal)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 9, 4)).astype(np.float32)
    jc = jp._ConvT2x(6)
    cv = jc.init(jax.random.PRNGKey(0), x)
    tc = tp._conv_t2x(4, 6)
    tc.load_state_dict({"weight": torch.from_numpy(np.ascontiguousarray(
        np.asarray(cv["params"]["conv"]["kernel"]).transpose(3, 2, 0, 1))),
        "bias": torch.from_numpy(np.asarray(cv["params"]["conv"]["bias"]))})
    with torch.no_grad():
        got = _nhwc(tc(_nchw(x)))
    assert got.shape == (2, 14, 18, 6)
    np.testing.assert_allclose(got, jc.apply(cv, x), **TOL)

    cfg = jp.PIRenderConfig(coeff_nc=9, descriptor_nc=16, mapping_layers=2)
    co = rng.standard_normal((2, 27, 9)).astype(np.float32)
    jm = jp.MappingNet(cfg)
    mv = _np(jm.init(jax.random.PRNGKey(1), co))
    tm = tp.MappingNet(tp.PIRenderConfig(coeff_nc=9, descriptor_nc=16, mapping_layers=2))
    sd = {}
    for name, key in [("first", "first.0")] + [(f"encoder{i}", f"encoder{i}.1") for i in range(2)]:
        sd[key + ".weight"] = torch.from_numpy(np.ascontiguousarray(
            mv["params"][name]["kernel"].transpose(2, 1, 0)))
        sd[key + ".bias"] = torch.from_numpy(mv["params"][name]["bias"])
    tm.load_state_dict(sd)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(co).transpose(1, 2)).numpy(),
                                   jm.apply(mv, co), **TOL)
        ref = exact_jit(jp.MappingNet(cfg, jnp.bfloat16).apply, mv, co)
        got = set_compute_dtype(tm, torch.bfloat16)(torch.from_numpy(co).transpose(1, 2))
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_grid_sample_matches_jax_and_torch():
    """The four-gather formula against JAX's (fp32 and a bf16 grid) and
    against F.grid_sample (fp32), with samples outside the image."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 8, 10, 3)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 6, 7, 2)).astype(np.float32)
    got = tp.grid_sample_bilinear(_nchw(img), torch.from_numpy(grid))
    np.testing.assert_allclose(_nhwc(got), jp.grid_sample_bilinear(img, grid), **TOL)
    ref = F.grid_sample(_nchw(img), torch.from_numpy(grid), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    jb = jp.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(grid, jnp.bfloat16))
    tb = tp.grid_sample_bilinear(_nchw(img), torch.from_numpy(grid).to(torch.bfloat16))
    assert tb.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(tb), np.asarray(jb), rtol=0, atol=1e-6)
    # the flow -> deformation grid
    flow = rng.standard_normal((1, 5, 6, 2)).astype(np.float32) * 3
    np.testing.assert_allclose(
        tp.convert_flow_to_deformation(_nchw(flow)).numpy(),
        jp.convert_flow_to_deformation(flow), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------- generator --


def test_face_generator_fp32_matches_jax(jax_side):
    gen = _port(jax_side["cfg"], jax_side["variables"])
    with torch.no_grad():
        out = gen(_nchw(jax_side["img"]), torch.from_numpy(jax_side["coeff"]).transpose(1, 2))
        warp = gen(_nchw(jax_side["img"]), torch.from_numpy(jax_side["coeff"]).transpose(1, 2),
                   stage="warp")
    ref = jax_side["f32"]
    assert set(out) == set(ref) and "fake_image" not in warp
    assert out["flow_field"].shape == (2, 2, S // 2, S // 2)
    for k in ref:
        got = out[k].numpy() if k == "deformation" else _nhwc(out[k])
        np.testing.assert_allclose(got, ref[k], err_msg=k, **TOL)
    for k in warp:  # the warp stage computes the full forward's warp, as JAX's
        got = warp[k].numpy() if k == "deformation" else _nhwc(warp[k])
        np.testing.assert_allclose(got, ref[k], err_msg=k, **TOL)


def test_face_generator_bf16_closer_than_jax_bf16_to_f32(jax_side):
    gen = _port(jax_side["cfg"], jax_side["variables"], torch.bfloat16)
    with torch.no_grad():
        out = gen(_nchw(jax_side["img"]), torch.from_numpy(jax_side["coeff"]).transpose(1, 2))
    assert out["fake_image"].dtype == torch.bfloat16 and out["warp_image"].dtype == torch.float32
    for k in ("flow_field", "deformation", "warp_image", "fake_image"):
        got = out[k] if k == "deformation" else out[k].permute(0, 2, 3, 1)
        assert_closer(f"FaceGenerator {k}", got, jax_side["bf16"][k], jax_side["f32"][k])


def _reference_net_g(cfg, seed=5):
    """A synthetic reference-named ``net_G`` trainer checkpoint: the port's
    names and shapes, seeded values, ``module.`` prefixed, under
    ``net_G_ema``."""
    state = tp.FaceGenerator.random_init(tp.PIRenderConfig(**dataclasses.asdict(cfg)), seed=seed,
                                         device="cpu").state_dict()
    g = torch.Generator().manual_seed(seed)
    sd = {f"module.{k}": v + 0.02 * torch.randn(v.shape, generator=g) for k, v in state.items()}
    return {"net_G_ema": sd, "net_G": {}}


def test_net_g_import_matches_jax_importer(jax_side, tmp_path):
    cfg = jax_side["cfg"]
    ck = _reference_net_g(cfg)
    jvars = jp.pirender_params_from_torch(ck["net_G_ema"], cfg)
    ref = _np(jax.jit(jp.FaceGenerator(cfg).apply)(jvars, jax_side["img"], jax_side["coeff"]))
    path = str(tmp_path / "net_g.pt")
    torch.save(ck, path)
    from avi_talking_tpu_torch.cli.run import load_net_g

    state = load_net_g(path, tp.PIRenderConfig(**dataclasses.asdict(cfg)))
    gen = tp.FaceGenerator(tp.PIRenderConfig(**dataclasses.asdict(cfg)))
    gen.load_state_dict(state)  # strict: every key present
    with torch.no_grad():
        out = gen(_nchw(jax_side["img"]), torch.from_numpy(jax_side["coeff"]).transpose(1, 2))
    for k in ("flow_field", "warp_image", "fake_image"):
        np.testing.assert_allclose(_nhwc(out[k]), ref[k], err_msg=k, **TOL)
    # the keys are checked: a missing one and a wrong shape are named
    sd = dict(ck["net_G_ema"])
    sd.pop("module.editing_net.decoder.final.model.0.bias")
    with pytest.raises(KeyError, match="final.model.0.bias"):
        tp.pirender_state_from_torch(sd, tp.PIRenderConfig(**dataclasses.asdict(cfg)))
    with pytest.raises(ValueError, match="shape"):
        tp.pirender_state_from_torch(ck, tp.PIRenderConfig(**dataclasses.asdict(
            dataclasses.replace(cfg, coeff_nc=12))))


# ------------------------------------------------------------ portrait --


def test_portrait_functions_bit_equal():
    rng = np.random.default_rng(4)
    exp = rng.standard_normal((7, 6)).astype(np.float32)
    jaw = rng.standard_normal((7, 3)).astype(np.float32)
    rot = rng.standard_normal((7, 3)).astype(np.float32)
    for kw in ({}, {"rot": rot, "cam": [1.0, 2.0, 3.0]}, {"cam": rot}):
        ref = np.asarray(jportrait.build_semantics(exp, jaw, **kw))
        got = tportrait.build_semantics(exp, jaw, **kw)
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(tportrait.semantic_windows(got, 3).numpy(),
                                      np.asarray(jportrait.semantic_windows(ref, 3)))
    with pytest.raises(ValueError):
        tportrait.build_semantics(exp, jaw, rot=rot[:5])
    base = rng.standard_normal(15).astype(np.float32)
    for num in (1, 4):
        f_ref, n_ref = jportrait.control_schedule(base, num=num)
        f_got, n_got = tportrait.control_schedule(base, num=num)
        assert n_got == n_ref
        np.testing.assert_array_equal(f_got, f_ref)
    frames = rng.uniform(-1.3, 1.3, (3, 4, 5, 3)).astype(np.float32)
    for a, b in zip(tportrait.frames_to_u8(frames), jportrait.frames_to_u8(frames)):
        np.testing.assert_array_equal(a, b)


def test_portrait_renderer_matches_jax(jax_side):
    """10 frames in chunks of 4 (the last padded by its last window), with
    the warp stream, at 2e-5; chunked equal to one frame a chunk."""
    rng = np.random.default_rng(6)
    cfg = jax_side["cfg"]
    descr = rng.standard_normal((10, cfg.coeff_nc)).astype(np.float32)
    src = jax_side["img"][0]
    ref = jportrait.PortraitRenderer(jp.FaceGenerator(cfg), jax_side["variables"], chunk=4).render(
        src, descr, return_warp=True)
    renderer = tportrait.PortraitRenderer(_port(cfg, jax_side["variables"]), chunk=4)
    got = renderer.render(src, descr, return_warp=True)
    for k in ("fake", "warp"):
        assert got[k].shape == (10, S, S, 3)
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2e-5, err_msg=k)
    one = tportrait.PortraitRenderer(renderer.generator, chunk=1).render(src, descr)
    np.testing.assert_allclose(one["fake"], got["fake"], rtol=0, atol=2e-5)


def test_tiny_portrait_matches_golden():
    """The golden tiny_portrait.json on JAX's seeded weights carried over,
    at test_golden.py's tolerances."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    rng = np.random.default_rng(11)
    src = rng.uniform(-1, 1, (16, 16, 3)).astype(np.float32)
    exp = rng.standard_normal((6, 6)).astype(np.float32) * 0.3
    jaw = rng.standard_normal((6, 3)).astype(np.float32) * 0.1
    descr = tportrait.build_semantics(exp, jaw)
    cfg = dataclasses.replace(jp.PIRenderConfig.tiny(), coeff_nc=int(descr.shape[-1]))
    gvars = jax.jit(jp.FaceGenerator(cfg).init)(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3)),
                                                jnp.zeros((1, 27, cfg.coeff_nc)))
    out = tportrait.PortraitRenderer(_port(cfg, gvars), chunk=8).render(src, descr,
                                                                         return_warp=True)
    np.testing.assert_allclose(float(out["fake"].mean()), golden["fake_mean"], rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(float(out["fake"].std()), golden["fake_std"], rtol=1e-3)
    np.testing.assert_allclose(float(out["warp"].mean()), golden["warp_mean"], rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(out["fake"][0, 0, 0], golden["fake_first_pixel"], rtol=1e-3,
                               atol=1e-4)


def _portrait(tmp_path, *extra):
    src = str(tmp_path / "src.png")
    write_png(src, np.random.default_rng(0).integers(0, 256, (20, 24, 3), dtype=np.uint8))
    return main(["portrait", "--source", src, "--tiny", "--device", "cpu", "--image-size", "16",
                 "--out", str(tmp_path / "out"), *extra])


def test_cli_portrait_coeffs_and_control(tmp_path, capsys):
    coeffs = str(tmp_path / "clip_coeffs.npz")
    rng = np.random.default_rng(1)
    np.savez(coeffs, exp=rng.standard_normal((5, 6)).astype(np.float32),
             jaw=rng.standard_normal((5, 3)).astype(np.float32) * 0.1)
    assert _portrait(tmp_path, "--coeffs", coeffs, "--chunk", "2", "--save-warp") == 0
    out, err = capsys.readouterr()
    assert "portrait: 5 frames" in out and "RANDOM-init" in err
    frames = sorted(os.listdir(tmp_path / "out" / "clip_coeffs_portrait_frames"))
    assert len(frames) == 5
    first = read_png(str(tmp_path / "out" / "clip_coeffs_portrait_frames" / frames[0]))
    assert first.shape == (16, 32, 3)  # warp | fake
    assert _portrait(tmp_path, "--control", "--control-exp-dims", "6", "--control-steps",
                     "2") == 0
    out = capsys.readouterr().out
    assert "control sweep: 18 legs, 36 frames" in out
    assert len(os.listdir(tmp_path / "out" / "control_portrait_frames")) == 36
    # --net-g needs the 59-d descriptor; --coeffs or --control is needed
    with pytest.raises(SystemExit, match="59-d"):
        _portrait(tmp_path, "--coeffs", coeffs, "--net-g", "x.pt")
    with pytest.raises(SystemExit, match="--coeffs"):
        _portrait(tmp_path)


def test_cli_portrait_needs_a_card_without_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    src = str(tmp_path / "src.png")
    write_png(src, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["portrait", "--source", src, "--control", "--tiny"])
