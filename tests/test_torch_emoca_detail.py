"""Port parity of DECA's detail stage and of the two EMOCA commands: one
detail step against JAX's jitted step (``E_detail`` and the generator, its
BatchNorm running statistics trained by Adam as JAX trains them; the coarse
towers unchanged), ``reconstruct``'s compute path (codes, vertices, the
shaded, textured and detail renders) at the golden reconstruct case, and
``train-emoca`` / ``reconstruct`` through the port's CLI on ``--device
cpu`` (a ``--root`` folder with landmarks and masks, the coarse -> detail
graft, ``--exp-only``, ``--emo-loss`` with a Lightning EmoNet file)."""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.core.projection import batch_orth_proj as jproj
from avi_talking_tpu.models import deca_detail as jdd
from avi_talking_tpu.models import emoca as jemoca
from avi_talking_tpu.train import emoca_trainer as jet
from avi_talking_tpu.viz import shading as jsh
from avi_talking_tpu_torch.cli import main
from avi_talking_tpu_torch.cli.reconstruct import reconstruct_frames
from avi_talking_tpu_torch.core.flame import FlameModel
from avi_talking_tpu_torch.infra.checkpoint import restore_checkpoint
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.models import deca_detail as tdd
from avi_talking_tpu_torch.models import emoca as temoca
from avi_talking_tpu_torch.train import emoca_trainer as tet
from avi_talking_tpu_torch.viz.pngio import write_png
from test_torch_emoca_train import (CPU, LR, S, _assets, _batch, _encoder, _grads_close,
                                    _jax_flame, _jax_step, _np_state, _t, _uv)
from _torch_threads import one_torch_thread  # noqa: F401

# ---------------------------------------------------------------- detail --


def _detail_generator():
    gen = tdd.DetailGenerator.random_init(3 + 6 + 4, init_size=2, seed=8, device="cpu")
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():  # statistics away from 0 / 1, so their gradients show
        for m in gen.modules():
            if isinstance(m, tdd.RunningStatsBatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
    return gen


@pytest.fixture(scope="module")
def detail_case():
    enc, gen = _encoder(with_detail=True), _detail_generator()
    jvars = jemoca.emoca_encoder_params_from_torch(_np_state(enc), with_detail=True)
    gvars = jdd.detail_generator_params_from_torch(_np_state(gen))
    assets, flame = _jax_flame()
    uv, faces = jnp.asarray(_uv(assets.v_template)), assets.faces
    dm = jdd.DecaDetailModel(generator=jdd.DetailGenerator(latent_dim=13, init_size=2),
                             variables=gvars, faces=faces, uv_coords=uv, uv_faces=faces,
                             uv_size=64)
    trainer = jet.DecaDetailTrainer(encoder=jemoca.EmocaEncoder(n_exp=6, with_detail=True,
                                                                n_detail=4),
                                    detail_model=dm, flame=flame, image_size=S,
                                    raster_chunk=256)
    tx, step = _jax_step(trainer.loss_fn)
    train = {"detail": jvars["params"]["detail"], "generator": gvars}
    batch = {"images": jnp.asarray(_batch(2)["images"])}
    new, _, terms, grads = step(train, tx.init(train), jvars, batch)
    new, grads = jax.tree.map(np.asarray, new), jax.tree.map(np.asarray, grads)
    from avi_talking_tpu_torch.infra.jax_params import (deca_encoder_state_from_jax,
                                                        detail_generator_state_from_jax)

    stats = jax.tree.map(np.asarray, jvars["batch_stats"]["detail"])
    return dict(
        terms={k: float(v) for k, v in terms.items()},
        e_detail=deca_encoder_state_from_jax(new["detail"], stats),
        e_detail_grad=deca_encoder_state_from_jax(grads["detail"], stats),
        gen=detail_generator_state_from_jax(new["generator"]),
        gen_grad=detail_generator_state_from_jax(grads["generator"]))


def test_detail_step_matches_jax(detail_case):
    enc, gen = _encoder(with_detail=True), _detail_generator()
    assets = _assets()
    flame = FlameModel(assets, n_shape=8, n_exp=6)
    uv = _t(_uv(assets.v_template))
    dm = tdd.DecaDetailModel(generator=gen, faces=assets.faces, uv_coords=uv,
                             uv_faces=assets.faces, uv_size=64)
    trainer = tet.DecaDetailTrainer(encoder=enc, detail_model=dm, flame=flame, image_size=S,
                                    raster_chunk=256)
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    opt = trainer.make_optimizer(LR)
    batch = {"images": _t(_batch(2)["images"])}
    opt.zero_grad()
    total, _ = trainer.loss_fn(batch)
    total.backward()
    grads = {"E_detail." + k: p.grad for k, p in enc.E_detail.named_parameters()}
    grads.update({k: p.grad for k, p in gen.named_parameters()})
    for k, t in gen.named_buffers():
        if t.requires_grad:
            grads[k] = t.grad
    want = {"E_detail." + k: v for k, v in detail_case["e_detail_grad"].items()}
    want.update(detail_case["gen_grad"])
    stats_keys = [k for k in want if k.endswith(("running_mean", "running_var"))
                  and not k.startswith("E_detail.")]
    assert len(stats_keys) == 12 and all(np.abs(want[k]).max() > 0 for k in stats_keys)
    _grads_close({k: g.numpy() for k, g in grads.items()}, want)
    opt.zero_grad()
    terms = trainer.train_step(opt, batch)
    # z_diff smooths the UV shading, whose normals at the edge of the
    # planar UVs' coverage come from zero-area triangles (points at 0 moved
    # by a 1e-2 displacement): their direction is rounding on either side,
    # a few border pixels of 4096 (none inside the covered region)
    for k, v in detail_case["terms"].items():
        np.testing.assert_allclose(float(terms[k]), v, rtol=1e-4,
                                   atol=1e-5 if k == "z_diff" else 1e-6, err_msg=k)
    # only E_detail and the generator move; its running statistics with them
    for k, v in enc.state_dict().items():
        if not k.startswith("E_detail."):
            assert torch.equal(v, before[k]), k
    new = {"E_detail." + k: v for k, v in detail_case["e_detail"].items()}
    new.update(detail_case["gen"])
    state = dict(enc.state_dict())
    state.update(gen.state_dict())
    for k, v in new.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert np.abs(state[k].detach().numpy() - v).max() <= 2 * LR, k
    for k in stats_keys:
        assert not np.array_equal(state[k].detach().numpy(), _np_state(_detail_generator())[k]), k


# ----------------------------------------------------------- reconstruct --


def _reconstruct_args(**kw):
    base = dict(tiny=True, checkpoint=None, flame_npz=None, size=32, detail=True,
                detail_checkpoint=None, uv_obj=None, textured=True, tex_npz=None)
    base.update(kw)
    return argparse.Namespace(**base)


def test_reconstruct_matches_jax():
    """``reconstruct --tiny --detail --textured``'s compute path at the
    golden reconstruct case (one 32^2 image of seed 7): JAX's
    ``cmd_reconstruct`` steps on the command's seeded weights (the encoder
    at n_exp 50, seed 0; the generator seed 1), carried by JAX's importers."""
    x = np.random.default_rng(7).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    codes, verts, shaded, textured, detail = reconstruct_frames(_reconstruct_args(), _t(x), CPU)

    enc = random_module(lambda: temoca.EmocaEncoder(with_detail=True, n_detail=4), CPU,
                        torch.Generator().manual_seed(0))
    gen = tdd.DetailGenerator.random_init(13, init_size=2, seed=1, device="cpu")
    jvars = jemoca.emoca_encoder_params_from_torch(_np_state(enc), with_detail=True)
    gvars = jdd.detail_generator_params_from_torch(_np_state(gen))
    assets, flame = _jax_flame()
    uv, faces = jnp.asarray(_uv(assets.v_template)), assets.faces

    @jax.jit
    def jrun(xx):
        c = jemoca.EmocaEncoder(with_detail=True, n_detail=4).apply(jvars, xx)
        c = {**c, "shape": c["shape"][:, :8], "exp": c["exp"][:, :6]}
        v = flame.vertices_only(c["shape"], c["exp"], jnp.concatenate(
            [jnp.zeros_like(c["pose"][:, :3]), c["pose"][:, 3:]], axis=1))
        p = jproj(v, jnp.asarray([[8.0, 0.0, -0.01]]))
        ndc = jnp.stack([p[..., 0], -p[..., 1], -p[..., 2]], axis=-1)
        sh = jsh.render_shaded(ndc, faces, 32, 32)
        tx = jsh.render_textured(ndc, faces, uv, faces, jnp.full((1, 8, 8, 3), 0.6), 32, 32)
        return c, v, sh, tx

    @jax.jit
    def jdecode(jaw, exp, code, v):
        # on the port's codes and vertices: the dense UV mesh's normals
        # amplify the encoder's rounding where its triangles are thin
        dm = jdd.DecaDetailModel(generator=jdd.DetailGenerator(latent_dim=13, init_size=2),
                                 variables=gvars, faces=faces, uv_coords=uv, uv_faces=faces,
                                 uv_size=64)
        return dm.decode(jaw, exp, code, v)[0]

    jdn = np.asarray(jdecode(*(jnp.asarray(t.numpy()) for t in (
        codes["pose"][:, 3:], codes["exp"], codes["detail"], verts))))
    jc, jv, jsd, jtx = jax.tree.map(np.asarray, jrun(jnp.asarray(x)))
    assert set(codes) == set(jc)
    for k, v in jc.items():
        np.testing.assert_allclose(codes[k].numpy(), v, rtol=1e-3, atol=1e-3, err_msg=k)
    np.testing.assert_allclose(verts.numpy(), jv, rtol=1e-3, atol=1e-4)
    for got, want in ((shaded, jsd), (textured, jtx)):
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    # the normals at the edge of the planar UVs' coverage come from
    # zero-area triangles, whose direction is rounding on either side: held
    # inside the coverage, where each pixel's 3 x 3 neighbourhood is covered
    assert detail.shape == (1, 64, 64, 3)
    assets = _assets()
    uv_v = tdd.world2uv(verts, assets.faces, _t(_uv(assets.v_template)), assets.faces, 64)
    inside = (torch.nn.functional.max_pool2d(
        (uv_v.abs().sum(-1) == 0).float()[:, None], 3, 1, 1)[:, 0] == 0).numpy()
    assert inside.mean() > 0.15
    np.testing.assert_allclose(detail.numpy()[inside], jdn[inside], atol=1e-4)


# --------------------------------------------------------------- commands --


@pytest.fixture(scope="module")
def face_root(tmp_path_factory):
    """Six 40^2 PNG frames (resized to --size 32 as JAX resizes them), 68
    landmarks each and a mask per frame."""
    root = tmp_path_factory.mktemp("faces")
    r = np.random.default_rng(3)
    os.makedirs(root / "masks")
    for i in range(6):
        write_png(str(root / f"f{i:02d}.png"), r.integers(0, 255, (40, 40, 3)).astype(np.uint8))
        write_png(str(root / "masks" / f"f{i:02d}.png"),
                  (r.uniform(0, 1, (40, 40, 1)) > 0.3).astype(np.uint8) * 255)
    np.save(root / "landmarks.npy", r.uniform(-0.8, 0.8, (6, 68, 2)).astype(np.float32))
    return str(root)


TINY = ["--tiny", "--device", "cpu", "--size", "32", "--batch-size", "2", "--log-every", "1"]


def _final(out):
    import ast

    return ast.literal_eval(out.split("final:")[-1].strip())


def test_frames_decode_as_jax(face_root):
    from avi_talking_tpu_torch.cli.train_emoca import _decode_frames
    from avi_talking_tpu.viz.pngio import read_image_normalized

    paths = sorted(os.path.join(face_root, p) for p in os.listdir(face_root)
                   if p.endswith(".png"))
    imgs = np.stack([read_image_normalized(paths[j]) for j in (1, 4)]) * 0.5 + 0.5
    want = np.asarray(jax.image.resize(jnp.asarray(imgs), (2, 32, 32, 3), "bilinear"))
    np.testing.assert_allclose(_decode_frames(paths, [1, 4], 32), want, atol=1e-6)


def test_train_emoca_command(face_root, tmp_path, capsys):
    ck = str(tmp_path / "coarse")
    assert main(["train-emoca", *TINY, "--root", face_root, "--steps", "2",
                 "--ckpt-dir", ck]) == 0
    out = capsys.readouterr()
    assert "data root: 6 frames (per-batch decode, seg masks)" in out.out
    assert {"landmark", "photometric", "total"} <= set(_final(out.out))
    state = restore_checkpoint(ck)["encoder"]
    assert "E_flame.layers.2.weight" in state and not any(k.startswith("E_detail") for k in state)

    detail = str(tmp_path / "detail")
    assert main(["train-emoca", *TINY, "--root", face_root, "--steps", "1", "--detail",
                 "--checkpoint", ck, "--ckpt-dir", detail]) == 0
    out = capsys.readouterr()
    assert "grafted coarse checkpoint" in out.err
    assert {"photometric_detailed", "z_reg", "z_diff", "z_sym", "detail_l1_0"} <= set(
        _final(out.out))
    saved = restore_checkpoint(detail)
    for k, v in state.items():  # the coarse towers come through unchanged
        assert torch.equal(saved["encoder"][k], v), k
    assert "l1.0.weight" in saved["generator"]

    assert main(["train-emoca", *TINY, "--steps", "1", "--exp-only", "--checkpoint", ck,
                 "--ckpt-dir", str(tmp_path / "exp")]) == 0
    capsys.readouterr()
    exp = restore_checkpoint(str(tmp_path / "exp"))["encoder"]
    for k, v in state.items():
        if k.startswith("E_flame."):
            assert torch.equal(exp[k], v), k
    assert not torch.equal(exp["E_expression.layers.2.weight"],
                           state["E_expression.layers.2.weight"])


def test_train_emoca_emo_loss_reads_a_lightning_file(tmp_path, capsys):
    emo = random_module(lambda: temoca.EmotionRecognitionModule(8), CPU,
                        torch.Generator().manual_seed(2))
    path = str(tmp_path / "emonet.ckpt")
    torch.save({"state_dict": dict(emo.state_dict(), **{"extra.weight": torch.zeros(1)}),
                "hyper_parameters": argparse.Namespace(n_expression=8)}, path)
    assert main(["train-emoca", *TINY, "--steps", "1", "--emo-loss",
                 "--emonet-checkpoint", path]) == 0
    out = capsys.readouterr()
    assert "RANDOM-init" not in out.err and "emotion" in _final(out.out)


def test_reconstruct_command(face_root, tmp_path, capsys):
    one = os.path.join(face_root, "f00.png")
    out_dir = str(tmp_path / "one")
    assert main(["reconstruct", "--image", one, "--tiny", "--device", "cpu", "--size", "32",
                 "--detail", "--textured", "--out-dir", out_dir]) == 0
    assert sorted(os.listdir(out_dir)) == ["f00_codes.npz", "f00_detail_normals.png",
                                           "f00_geometry.png", "f00_textured.png"]
    z = np.load(os.path.join(out_dir, "f00_codes.npz"))
    assert z["exp"].shape == (1, 6) and z["vertices"].shape[0] == 1
    folder = str(tmp_path / "folder")
    assert main(["reconstruct", "--image", face_root, "--tiny", "--device", "cpu", "--size",
                 "32", "--out-dir", folder]) == 0
    assert "6 geometry frames" in capsys.readouterr().out
    assert len([p for p in os.listdir(folder) if p.endswith("_geometry.png")]) == 6


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the no-card error")
@pytest.mark.parametrize("argv", [["train-emoca", "--tiny", "--steps", "1"],
                                  ["reconstruct", "--image", "x.png", "--tiny"]])
def test_commands_need_the_card_without_device(argv):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
