"""Port parity of the stage-1 render and emotion terms: the VGG19 tower
(1e-3 / 1e-4, as tests/test_perceptual.py) and its torchvision importer,
``PerceptualLoss`` with the style term (value and input gradient),
``PIRenderRenderLoss`` with and without EmoNet on JAX's frame indices
(value, and the gradient to the coefficients against ``jax.grad``), three
``FaceFormerTrainer`` steps with both terms against optax, and
``train-faceformer --root --render-loss --emo-loss`` on a tree the test
writes; weights carried from JAX by ``infra.jax_params``."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avi_talking_tpu.models import emoca as jemoca
from avi_talking_tpu.models import faceformer as jff
from avi_talking_tpu.models import pirender as jp
from avi_talking_tpu.train import perceptual as jpc
from avi_talking_tpu.train import render_loss as jrl
from avi_talking_tpu.train.faceformer_trainer import FaceFormerTrainer as JTrainer
from avi_talking_tpu_torch.cli import main
from avi_talking_tpu_torch.cli.train import synthetic_batches
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.infra.jax_params import (emotion_module_state_from_jax,
                                                    faceformer_state_from_jax,
                                                    pirender_state_from_jax,
                                                    vgg19_state_from_jax)
from avi_talking_tpu_torch.models import emoca as temoca
from avi_talking_tpu_torch.models import faceformer as tff
from avi_talking_tpu_torch.models import pirender as tp
from avi_talking_tpu_torch.train import perceptual as tpc
from avi_talking_tpu_torch.train import render_loss as trl
from avi_talking_tpu_torch.train.faceformer_trainer import FaceFormerTrainer
from avi_talking_tpu_torch.train.optim import adamw
from _torch_threads import one_torch_thread  # noqa: F401

B, T, H = 2, 6, 32  # batch, frames, crop side
TAPS = ("relu_1_1", "relu_2_1")
N_SAMPLES = 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _load(module, state):
    module.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return module.eval()


def _batch(seed=0):
    """Pose, camera, crops and neutral crops (NHWC) of a (B, T) window."""
    rng = np.random.default_rng(seed)
    return {"pose": rng.standard_normal((B, T, 6)).astype(np.float32) * 0.1,
            "cam": rng.standard_normal((B, T, 3)).astype(np.float32),
            "img": rng.uniform(-1, 1, (B, T, H, H, 3)).astype(np.float32),
            "ref_img": rng.uniform(-1, 1, (B, T, H, H, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def towers():
    """The port's seeded tiny PIRender (descriptor 9 + 6), VGG19 and EmoNet
    carried to JAX by its reference importers (the port keeps the reference
    names), the coefficient statistics, and the frames JAX's loss draws."""
    rng = np.random.default_rng(1)
    cfg = dataclasses.replace(jp.PIRenderConfig.tiny(), coeff_nc=15)
    gen = tp.FaceGenerator.random_init(tp.PIRenderConfig(**dataclasses.asdict(cfg)), seed=2,
                                       device="cpu")
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():  # biases and norms away from their init
        for v in gen.parameters():
            v.add_(0.02 * torch.randn(v.shape, generator=g))
    vgg = tpc.Vgg19Features.random_init(TAPS, seed=3, device="cpu")
    emo = random_module(lambda: temoca.EmotionRecognitionModule(n_expression=8),
                        torch.device("cpu"), torch.Generator().manual_seed(4))
    return {"cfg": cfg, "gen": gen.state_dict(), "vgg": vgg.state_dict(),
            "emo": emo.state_dict(),
            "gvars": jp.pirender_params_from_torch(gen.state_dict(), cfg),
            "vgg_params": jpc.vgg19_params_from_torch(vgg.state_dict()),
            "emo_vars": jemoca.emotion_module_params_from_torch(emo.state_dict()),
            "mean": rng.standard_normal(59).astype(np.float32) * 0.1,
            "std": rng.uniform(0.5, 1.5, 59).astype(np.float32),
            "idx": np.asarray(jax.random.randint(jax.random.PRNGKey(0), (N_SAMPLES,), 0, T))}


def _jax_loss(tw, emonet: bool, n_samples=N_SAMPLES):
    vgg = jpc.Vgg19Features(taps=TAPS)
    mk = lambda: jpc.PerceptualLoss(vgg, layers=TAPS, num_scales=2)  # noqa: E731
    return jrl.PIRenderRenderLoss(
        generator=jp.FaceGenerator(tw["cfg"]), generator_params=tw["gvars"],
        perceptual_warp=mk(), perceptual_final=mk(), vgg_params=tw["vgg_params"],
        coeff_mean=jnp.asarray(tw["mean"]), coeff_std=jnp.asarray(tw["std"]),
        n_samples=n_samples,
        emonet=jemoca.EmoNetLoss(jemoca.EmotionRecognitionModule(n_expression=8))
        if emonet else None, emonet_vars=tw["emo_vars"] if emonet else None)


def _port_loss(tw, emonet: bool, frame_idx=None, n_samples=N_SAMPLES):
    gen = _load(tp.FaceGenerator(tp.PIRenderConfig(**dataclasses.asdict(tw["cfg"]))), tw["gen"])
    vgg = _load(tpc.Vgg19Features(TAPS), tw["vgg"])
    mk = lambda: tpc.PerceptualLoss(vgg, layers=TAPS, num_scales=2)  # noqa: E731
    emo = None
    if emonet:
        emo = temoca.EmoNetLoss(_load(temoca.EmotionRecognitionModule(n_expression=8),
                                      tw["emo"]))
    return trl.PIRenderRenderLoss(
        generator=gen, perceptual_warp=mk(), perceptual_final=mk(),
        coeff_mean=torch.from_numpy(tw["mean"]), coeff_std=torch.from_numpy(tw["std"]),
        n_samples=n_samples, emonet=emo, frame_idx=frame_idx)


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-12))


# ---------------------------------------------------------------- VGG --


def test_carriers_invert_the_reference_importers(towers):
    """``infra.jax_params`` carries JAX's variables back to the port state
    they were imported from, bit for bit (the port keeps the reference's
    names, JAX's importers rename them)."""
    for carried, state in ((pirender_state_from_jax(towers["gvars"]), towers["gen"]),
                           (vgg19_state_from_jax(towers["vgg_params"]), towers["vgg"]),
                           (emotion_module_state_from_jax(towers["emo_vars"]), towers["emo"])):
        assert set(carried) == set(state)
        for k, v in state.items():
            np.testing.assert_array_equal(np.asarray(carried[k]), v.numpy(), err_msg=k)



def test_vgg19_tower_and_importer_match_jax():
    """Every tap on (2, 32, 32, 3); the torchvision ``features.N`` importer
    against JAX's ``vgg19_params_from_torch`` on a synthetic state dict."""
    x = np.random.default_rng(0).uniform(-1, 1, (2, H, H, 3)).astype(np.float32)
    jm = jpc.Vgg19Features()
    apply = jax.jit(jm.apply)
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(1), x)["params"])
    ref = _np(apply({"params": params}, x))
    tm = _load(tpc.Vgg19Features(), vgg19_state_from_jax(params))
    with torch.no_grad():
        got = tm(_nchw(x))
    assert set(got) == set(ref) == set(tpc.ALL_TAPS)
    for k in ref:
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), ref[k], rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    g = torch.Generator().manual_seed(0)
    sd = {k: v + 0.01 * torch.randn(v.shape, generator=g) for k, v in
          tpc.Vgg19Features.random_init(seed=7, device="cpu").state_dict().items()}
    sd["classifier.0.weight"] = torch.zeros(4, 4)  # vgg19()'s head: left out
    ref = _np(apply({"params": jpc.vgg19_params_from_torch(sd)}, x))
    tm.load_state_dict(tpc.vgg19_state_from_torch(sd))
    with torch.no_grad():
        got = tm(_nchw(x))
    for k in ref:
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), ref[k], rtol=1e-3,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("criterion,style", [("l1", True), ("l2", False)])
def test_perceptual_loss_matches_jax(towers, criterion, style):
    """Three scales (32, 16, 8) with the style term at scale 0: the value
    and its gradient to the prediction."""
    rng = np.random.default_rng(5)
    pred = rng.uniform(-1, 1, (B, H, H, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (B, H, H, 3)).astype(np.float32)
    jl = jpc.PerceptualLoss(jpc.Vgg19Features(taps=TAPS), layers=TAPS, criterion=criterion,
                            use_style_loss=style)
    ref, ref_g = jax.jit(jax.value_and_grad(lambda p: jl(towers["vgg_params"], p, target)))(pred)
    vgg = _load(tpc.Vgg19Features(TAPS), towers["vgg"])
    tl = tpc.PerceptualLoss(vgg, layers=TAPS, criterion=criterion, use_style_loss=style)
    p = _nchw(pred).requires_grad_(True)
    got = tl(p, _nchw(target))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-4)
    assert _rel(p.grad.permute(0, 2, 3, 1).numpy(), ref_g) < 1e-3
    if style:  # the gram term adds to the feature distances
        plain = tpc.PerceptualLoss(vgg, layers=TAPS, criterion=criterion)(_nchw(pred),
                                                                            _nchw(target))
        assert float(got) > float(plain)


# --------------------------------------------------------- render loss --


# with EmoNet one frame (JAX's frame loop unrolls; ResNet-50's gradient is
# most of the compile), without it two
@pytest.mark.parametrize("emonet", [False, True])
def test_render_loss_value_and_gradient_match_jax(towers, emonet):
    rng = np.random.default_rng(6)
    pred = rng.standard_normal((B, T, 9)).astype(np.float32) * 0.3
    batch = _batch(7)
    n = 1 if emonet else N_SAMPLES
    jl = _jax_loss(towers, emonet, n)

    def scalar(p):
        out = jl(p, {k: jnp.asarray(v) for k, v in batch.items()})
        return (out["render"] + out["emo"], out) if emonet else (out, out)

    (_, ref), ref_g = jax.jit(jax.value_and_grad(scalar, has_aux=True))(pred)
    tl = _port_loss(towers, emonet, n_samples=n)
    p = torch.from_numpy(pred).requires_grad_(True)
    idx = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (n,), 0, T))  # JAX's draw
    got = tl(p, {k: torch.from_numpy(v) for k, v in batch.items()}, frame_idx=idx)
    total = got["render"] + got["emo"] if emonet else got
    total.backward()
    if emonet:
        assert set(got) == set(ref) == {"render", "emo"}
        for k in ref:
            np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4, err_msg=k)
        assert float(got["emo"]) > 0
    else:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-4)
    assert float(np.abs(ref_g).max()) > 0
    assert _rel(p.grad.numpy(), ref_g) < 1e-3
    # the generator, VGG and EmoNet are frozen: only the coefficients get gradients
    assert all(q.grad is None for q in tl.generator.parameters())


def test_render_loss_draws_its_frames(towers):
    """Without frame_idx the frames come from the loss's own generator
    (seed 0 here): the value is that of the frames it drew, passed in."""
    rng = np.random.default_rng(8)
    pred = torch.from_numpy(rng.standard_normal((B, T, 9)).astype(np.float32))
    batch = {k: torch.from_numpy(v) for k, v in _batch(9).items()}
    drawn = torch.randint(0, T, (N_SAMPLES,), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = _port_loss(towers, False)(pred, batch)
        ref = _port_loss(towers, False)(pred, batch, frame_idx=drawn)
    assert float(got) == float(ref)
    mask = trl.upper_face_mask_like(torch.zeros(2, 3, 6, 4))
    assert mask.shape == (3, 6, 4) and float(mask[:, :3].min()) == 1 and float(mask[:, 3:].max()) == 0
    np.testing.assert_array_equal(trl.obtain_seq_index(1, 5, 3).numpy(),
                                  np.asarray(jrl.obtain_seq_index(1, 5, 3)))


def test_faceformer_trainer_three_steps_with_both_terms_match_optax(towers):
    """Three AdamW steps with the render and emotion terms (0.015 / 0.15),
    the render loss on JAX's frame (PRNGKey(0) each step; one frame a step
    here, which halves JAX's compile): the metrics at each step (1e-4) and
    every parameter after them (1e-4)."""
    cfg = jff.FaceFormerConfig.tiny()
    frame_idx = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (1,), 0, T))
    src = synthetic_batches(tff.FaceFormerConfig.tiny(), B, T, seed=0, device="cpu")
    extra = [_batch(10 + i) for i in range(3)]
    batches = [{**next(src), **{k: torch.from_numpy(v) for k, v in e.items()}} for e in extra]
    jb = [{k: v.numpy() for k, v in b.items()} for b in batches]
    jm = jff.FaceFormerCoeff(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jb[0]["audio"], jb[0]["coeff"],
                              jb[0]["eye_embed"], jb[0]["emo_embed"], jb[0]["ref_coeff"])
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.05).astype(np.float32), params)

    tm = tff.FaceFormerCoeff.random_init(tff.FaceFormerConfig.tiny(), device="cpu")
    tm.load_state_dict({k: torch.as_tensor(v)
                        for k, v in faceformer_state_from_jax(params["params"]).items()})
    trainer = FaceFormerTrainer(model=tm, optimizer=adamw(tm.parameters(), 1e-4),
                                render_loss_fn=_port_loss(towers, True, frame_idx, 1))
    tx = optax.adamw(1e-4)
    step = jax.jit(JTrainer(model=jm, tx=tx, render_loss_fn=_jax_loss(towers, True, 1)).train_step)
    opt = tx.init(params)
    for i in range(3):
        params, opt, jmetrics = step(params, opt, jb[i], jax.random.PRNGKey(i))
        metrics = trainer.train_step(batches[i])
        assert set(metrics) == set(jmetrics) == {"coeff", "render", "emo", "loss"}
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), atol=1e-4,
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    ref = faceformer_state_from_jax(_np(params["params"]))
    got = tm.state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=1e-4, rtol=0, err_msg=k)


def test_trainer_weights_a_plain_render_and_an_emo_term():
    """A scalar render term (0.015) and ``emo_loss_fn`` (0.15), as JAX's."""
    tm = tff.FaceFormerCoeff.random_init(tff.FaceFormerConfig.tiny(), device="cpu")
    trainer = FaceFormerTrainer(model=tm, optimizer=adamw(tm.parameters(), 1e-4),
                                render_loss_fn=lambda p, b: (p ** 2).mean() + 2.0,
                                emo_loss_fn=lambda p, b: p.abs().mean() + 3.0)
    batch = next(synthetic_batches(tff.FaceFormerConfig.tiny(), 2, 8, seed=0, device="cpu"))
    loss, m = trainer.loss_fn(batch)
    assert set(m) == {"coeff", "render", "emo", "loss"}
    np.testing.assert_allclose(float(loss), float(m["coeff"] + 0.015 * m["render"]
                                                  + 0.15 * m["emo"]), rtol=1e-6)


# ------------------------------------------------------------- command --


@pytest.fixture(scope="module")
def mead_tree(tmp_path_factory):
    from test_torch_train_data import CLIPS, _write_clip

    root = tmp_path_factory.mktemp("mead_render")
    rng = np.random.default_rng(0)
    for name in CLIPS[:3]:
        _write_clip(root, name, rng, "EMOCA_v2_lr_mse_20/processed_x/detections")
    return str(root)


def _final(out):
    line = [x for x in out.splitlines() if x.startswith("final:")]
    assert len(line) == 1
    return eval(line[0][len("final:"):], {})  # a dict of floats


def test_cli_train_faceformer_root_render_and_emo(mead_tree, tmp_path, capsys):
    args = ["train-faceformer", "--tiny", "--root", mead_tree, "--device", "cpu", "--steps", "1",
            "--batch-size", "2", "--seq-length", "6"]
    assert main([*args, "--render-loss", "--emo-loss"]) == 0
    out, err = capsys.readouterr()
    final = _final(out)
    assert set(final) == {"coeff", "render", "emo", "loss"}
    assert final["render"] > 0 and final["emo"] > 0 and np.isfinite(final["loss"])
    assert "EmoNet is RANDOM-init" in err
    # --emonet-checkpoint: a reference-named state dict read strictly
    ck = str(tmp_path / "emonet.pt")
    emo = random_module(lambda: temoca.EmotionRecognitionModule(n_expression=8),
                        torch.device("cpu"), torch.Generator().manual_seed(9))
    torch.save({"state_dict": emo.state_dict()}, ck)
    assert main([*args, "--emo-loss", "--emonet-checkpoint", ck]) == 0
    out, err = capsys.readouterr()
    final = _final(out)
    assert "EmoNet is RANDOM-init" not in err and final["emo"] > 0
    # with --emo-loss alone the render term is computed and weighted 0, as in JAX
    coeff_only = final["coeff"] + 0.15 * final["emo"]
    np.testing.assert_allclose(final["loss"], coeff_only, rtol=1e-5)


def test_render_term_builds_the_jax_loss(mead_tree):
    """``cli.train.render_term``: two frames, the tiny taps at one scale,
    the dataset's statistics, EmoNet only with --emo-loss."""
    from avi_talking_tpu_torch.cli.train import mead_builder, render_term

    args = types.SimpleNamespace(root=mead_tree, seq_length=6, tiny=True, emo_loss=False,
                                 render_loss=True, emonet_checkpoint=None, seed=0)
    cfg = tff.FaceFormerConfig.tiny()
    loss = render_term(args, cfg, mead_builder(args, cfg), torch.device("cpu"))
    assert loss.n_samples == 2 and loss.emonet is None
    assert loss.perceptual_warp.layers == ("relu_1_1",) and loss.perceptual_final.num_scales == 1
    assert loss.generator.cfg.coeff_nc == cfg.vertice_dim + 6
    assert loss.coeff_mean.shape == (59,)
