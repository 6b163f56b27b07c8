"""Port parity of PIRender's training: the GAN objectives, ``SpectralConv``
(sigma from the stored u, v; one power iteration only when asked), the
discriminators and their reference importers, ``PIRenderTrainer`` through
the warp, full and GAN stages against optax (the editing net's first
full-stage update by optax's one step count), the golden ``pirender``
case of ``tiny_train.json``, ``VideoPairDataset`` bit-equal to JAX's
draws, and ``train-pirender --tiny --device cpu``."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avi_talking_tpu.data import pirender_pairs as jpairs
from avi_talking_tpu.models import discriminator as jd
from avi_talking_tpu.models import pirender as jp
from avi_talking_tpu.train import gan as jgan
from avi_talking_tpu.train import perceptual as jpc
from avi_talking_tpu.train import pirender_trainer as jpt
from avi_talking_tpu_torch.cli import main
from avi_talking_tpu_torch.data import pirender_pairs as tpairs
from avi_talking_tpu_torch.infra.checkpoint import restore_checkpoint
from avi_talking_tpu_torch.infra.jax_params import (discriminator_state_from_jax,
                                                    pirender_state_from_jax,
                                                    vgg19_state_from_jax)
from avi_talking_tpu_torch.models import discriminator as td
from avi_talking_tpu_torch.models import pirender as tp
from avi_talking_tpu_torch.train import gan as tgan
from avi_talking_tpu_torch.train import perceptual as tpc
from avi_talking_tpu_torch.train import pirender_trainer as tpt
from _torch_threads import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_train.json")
TAPS = ("relu_1_1", "relu_2_1")
# the warp's gradients jump where a sample crosses a pixel edge: after some
# ten steps the two sides' trajectories part at such a jump (their losses
# agree to 1e-6 up to it), so the stages stay short
WARP_STEPS, FULL_STEPS = 3, 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _load(module, state):
    module.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state.items()})
    return module


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-12))


# ---------------------------------------------------------------- GAN --


def _scales(rng, n_scales=2):
    return [[rng.standard_normal((2, 3, 8, 8)).astype(np.float32)]
            + [rng.standard_normal((2, 4, 5 - i, 5 - i)).astype(np.float32) for i in range(3)]
            for _ in range(n_scales)]


def _to_torch(out):
    return [[torch.from_numpy(np.ascontiguousarray(a)) for a in s] for s in out]


def _to_jax(out):
    return [[jnp.asarray(a.transpose(0, 2, 3, 1)) for a in s] for s in out]


@pytest.mark.parametrize("mode", ["hinge", "lsgan", "vanilla"])
def test_gan_losses_match_jax(mode):
    rng = np.random.default_rng(0)
    real, fake = _scales(rng), _scales(rng)
    for r, f in ((real, fake), (real[0], fake[0]), (real[0][-1], fake[0][-1])):
        tr = _to_torch(r) if isinstance(r[0], list) else (
            [torch.from_numpy(a) for a in r] if isinstance(r, list) else torch.from_numpy(r))
        tf = _to_torch(f) if isinstance(f[0], list) else (
            [torch.from_numpy(a) for a in f] if isinstance(f, list) else torch.from_numpy(f))
        jr = jax.tree.map(jnp.asarray, r)
        jf = jax.tree.map(jnp.asarray, f)
        np.testing.assert_allclose(float(tgan.gan_loss_d(tr, tf, mode)),
                                   float(jgan.gan_loss_d(jr, jf, mode)), rtol=1e-6)
        np.testing.assert_allclose(float(tgan.gan_loss_g(tf, mode)),
                                   float(jgan.gan_loss_g(jf, mode)), rtol=1e-6)
    with pytest.raises(ValueError):
        tgan.gan_loss_g(torch.zeros(2), "wgan")


def test_feature_matching_matches_jax_and_detaches_the_real_side():
    rng = np.random.default_rng(1)
    real, fake = _scales(rng), _scales(rng)
    tr = [[t.requires_grad_(True) for t in s] for s in _to_torch(real)]
    tf = [[t.requires_grad_(True) for t in s] for s in _to_torch(fake)]
    got = tgan.feature_matching_loss(tr, tf)
    ref = jgan.feature_matching_loss(_to_jax(real), _to_jax(fake))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    np.testing.assert_allclose(float(tgan.feature_matching_loss(tr[0], tf[0])),
                               float(jgan.feature_matching_loss(_to_jax(real)[0],
                                                                _to_jax(fake)[0])), rtol=1e-6)
    got.backward()
    assert all(t.grad is None for s in tr for t in s)
    assert tf[0][0].grad is None and tf[0][-1].grad is None  # the input and the logits: skipped
    assert float(tf[0][1].grad.abs().max()) > 0


# ------------------------------------------------------- discriminators --


def test_spectral_conv_matches_jax_with_sigma_fixed():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 9, 4)).astype(np.float32)
    jm = jd.SpectralConv(6, 4, 2, 2)
    v = _np(jm.init(jax.random.PRNGKey(0), x))
    tm = td.SpectralConv(4, 6, 4, 2, 2)
    _load(tm, {"weight_orig": v["params"]["kernel"].transpose(3, 2, 0, 1),
               "bias": v["params"]["bias"] + 0.1, "weight_u": v["spectral"]["u"],
               "weight_v": v["spectral"]["v"]})
    v["params"]["bias"] = v["params"]["bias"] + 0.1
    u0, v0 = tm.weight_u.detach().clone(), tm.weight_v.detach().clone()
    ref = jm.apply(v, x)
    for _ in range(2):  # no power iteration without update_stats: sigma stays
        got = tm(_nchw(x))
        np.testing.assert_allclose(_nhwc(got), ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(tm.weight_u, u0) and torch.equal(tm.weight_v, v0)
    # the initial u, v are normalised ones vectors
    fresh = td.SpectralConv(4, 6, 4, 2, 2)
    np.testing.assert_allclose(fresh.weight_u.detach().numpy(), v["spectral"]["u"], rtol=1e-6)
    # the gradient runs through W (sigma included)
    tw = tm.weight_orig
    (tm(_nchw(x)) ** 2).sum().backward()
    jg = jax.grad(lambda k: (jm.apply({"params": {**v["params"], "kernel": k},
                                       "spectral": v["spectral"]}, x) ** 2).sum())(
        v["params"]["kernel"])
    assert _rel(tw.grad.permute(2, 3, 1, 0).numpy(), jg) < 1e-4
    # one power iteration when asked, as JAX's update_stats=True
    ref, upd = jm.apply(v, x, update_stats=True, mutable=["spectral"])
    got = tm(_nchw(x), update_stats=True)
    np.testing.assert_allclose(_nhwc(got), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.weight_u.detach().numpy(), upd["spectral"]["u"], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tm.weight_v.detach().numpy(), upd["spectral"]["v"], rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("norm", ["spectralinstance", "instance", "none"])
def test_multiscale_discriminator_matches_jax(norm):
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jm = jd.MultiscaleDiscriminator(num_d=2, ndf=8, n_layers=3, norm=norm)
    v = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    ref = jax.jit(jm.apply)(v, x)
    tm = _load(td.MultiscaleDiscriminator(num_d=2, ndf=8, n_layers=3, norm=norm),
               discriminator_state_from_jax(v))
    with torch.no_grad():
        got = tm(_nchw(x))
    assert len(got) == len(ref) == 2
    for gs, rs in zip(got, ref):
        assert len(gs) == len(rs) == 5  # input, three stages, logits
        for g, r in zip(gs, rs):
            assert _rel(_nhwc(g), r) < 1e-5


def test_discriminator_importers_match_jax():
    """Synthetic reference-named state dicts (stored u, v away from their
    init) through JAX's ``*_params_from_torch`` and the port's
    ``*_state_from_torch``."""
    x = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    g = torch.Generator().manual_seed(1)
    ms = td.MultiscaleDiscriminator.random_init(seed=5, device="cpu", num_d=2, ndf=8, n_layers=3)
    sd = {}
    for k, v in ms.state_dict().items():
        if k.endswith(("weight_u", "weight_v")):
            w = torch.randn(v.shape, generator=g)
            v = w / w.norm()
        sd[f"net_D.{k}"] = v + (0.01 * torch.randn(v.shape, generator=g)
                                if k.endswith("bias") else 0)
    ref = jd.MultiscaleDiscriminator(num_d=2, ndf=8, n_layers=3).apply(
        jd.multiscale_params_from_torch(sd, num_d=2, n_layers=3, prefix="net_D."), x)
    tm = td.MultiscaleDiscriminator(num_d=2, ndf=8, n_layers=3)
    tm.load_state_dict(td.multiscale_state_from_torch(sd, num_d=2, n_layers=3, prefix="net_D."))
    with torch.no_grad():
        got = tm(_nchw(x))
    for gs, rs in zip(got, ref):
        for a, b in zip(gs, rs):
            assert _rel(_nhwc(a), b) < 1e-5
    one = td.nlayer_state_from_torch(sd, 3, "net_D.discriminator_1.")
    assert set(one) == set(td.NLayerDiscriminator(8, 3).state_dict())

    img = td.ImageDiscriminator(3, 8, 3)
    isd = {}
    for k, v in img.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        w = torch.randn(v.shape, generator=g) * (0.1 if v.dim() > 1 else 0.2)
        isd[k] = (w.abs() + 0.5) if k.endswith("running_var") else w
    jvars = jd.image_discriminator_params_from_torch(isd, 3)
    ref = jd.ImageDiscriminator(ndf=8, n_layers=3).apply(jvars, x)
    img.load_state_dict(td.image_discriminator_state_from_torch(isd, 3))
    with torch.no_grad():
        assert _rel(_nhwc(img(_nchw(x))), ref) < 1e-5
    # and the carrier from JAX's variables, train mode included (batch
    # statistics; the running ones updated as flax's momentum 0.9)
    back = _load(td.ImageDiscriminator(3, 8, 3), discriminator_state_from_jax(_np(jvars)))
    ref, upd = jd.ImageDiscriminator(ndf=8, n_layers=3).apply(jvars, x, train=True,
                                                              mutable=["batch_stats"])
    got = back(_nchw(x), train=True)
    assert _rel(_nhwc(got), ref) < 1e-5
    np.testing.assert_allclose(back.model[3].running_var.numpy(),
                               np.asarray(upd["batch_stats"]["bn1"]["var"]), rtol=1e-5)


def test_feature_discriminator_matches_jax():
    x = np.random.default_rng(5).standard_normal((3, 512)).astype(np.float32)
    jm = jd.FeatureDiscriminator(num_labels=7)
    v = _np(jm.init(jax.random.PRNGKey(0), x))
    tm = td.FeatureDiscriminator(7)
    _load(tm, {"fc.weight": v["params"]["fc"]["kernel"].T, "fc.bias": v["params"]["fc"]["bias"]})
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), jm.apply(v, x), rtol=1e-5,
                                   atol=1e-6)
        kept = tm(torch.from_numpy(x), train=True, generator=torch.Generator().manual_seed(0))
    assert kept.shape == (3, 7)
    with pytest.raises(ValueError):
        tm(torch.from_numpy(x), train=True)


# ------------------------------------------------------------- trainer --


@pytest.fixture(scope="module")
def start():
    """golden_cases.pirender_case's batch and JAX-initialised variables."""
    cfg = jp.PIRenderConfig.tiny()
    d = np.random.default_rng(3)
    batch = {"input_image": d.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32),
             "coeff_window": d.standard_normal((1, 27, cfg.coeff_nc)).astype(np.float32),
             "target_image": d.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)}
    params = _np(jax.jit(jp.FaceGenerator(cfg).init)(jax.random.PRNGKey(0), batch["input_image"],
                                                     batch["coeff_window"]))
    vgg_params = _np(jax.jit(jpc.Vgg19Features(taps=TAPS).init)(
        jax.random.PRNGKey(1), batch["input_image"])["params"])
    return cfg, batch, params, vgg_params


def _port_trainer(cfg, params, vgg_params, disc_state=None):
    gen = _load(tp.FaceGenerator(tp.PIRenderConfig(**dataclasses.asdict(cfg))),
                pirender_state_from_jax(params))
    vgg = _load(tpc.Vgg19Features(TAPS), vgg19_state_from_jax(vgg_params)).requires_grad_(False)
    opt, sched = tpt.make_pirender_optimizer(gen.parameters(), 1e-4)
    disc = opt_d = None
    if disc_state is not None:
        disc = _load(td.MultiscaleDiscriminator(num_d=1, ndf=8, n_layers=2), disc_state)
        opt_d = torch.optim.Adam(disc.parameters(), lr=1e-4, betas=(0.5, 0.999), eps=1e-8)
    return tpt.PIRenderTrainer(
        generator=gen, optimizer=opt, scheduler=sched,
        perceptual_warp=tpc.PerceptualLoss(vgg, layers=TAPS, num_scales=1),
        perceptual_final=tpc.PerceptualLoss(vgg, layers=TAPS, num_scales=1, use_style_loss=True),
        discriminator=disc, optimizer_d=opt_d)


@pytest.fixture(scope="module")
def stages(start):
    """JAX's trainer from golden_cases' start: WARP_STEPS warp steps, then
    FULL_STEPS full ones (every step's metrics, the variables after each
    stage); then, at the GAN stage's start, both GAN objectives with their
    gradients and one optax update of each (G's from its Adam state, D's
    from a fresh one), and G's Adam state."""
    cfg, batch, params, vgg_params = start
    vgg = jpc.Vgg19Features(taps=TAPS)
    disc = jd.MultiscaleDiscriminator(num_d=1, ndf=8, n_layers=2)
    dp = _np(jax.jit(disc.init)(jax.random.PRNGKey(2), batch["target_image"]))
    tx, tx_d = jpt.make_pirender_optimizer(1e-4), optax.adam(1e-4, b1=0.5, b2=0.999)
    trainer = jpt.PIRenderTrainer(
        generator=jp.FaceGenerator(cfg), tx=tx,
        perceptual_warp=jpc.PerceptualLoss(vgg, layers=TAPS, num_scales=1),
        perceptual_final=jpc.PerceptualLoss(vgg, layers=TAPS, num_scales=1, use_style_loss=True),
        vgg_params=vgg_params, discriminator=disc, tx_d=tx_d)
    step = trainer.jitted_train_step()
    out = {"cfg": cfg, "batch": batch, "start": params, "vgg_params": vgg_params,
           "d_start": dp, "metrics": [], "after": {}}
    p, opt = params, tx.init(params)
    for i in range(WARP_STEPS + FULL_STEPS):
        p, opt, m = step(p, opt, batch, i < WARP_STEPS)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i + 1 in (WARP_STEPS, WARP_STEPS + 1, WARP_STEPS + FULL_STEPS):
            out["after"][i + 1] = _np(p)
    d_loss, d_grad = jax.jit(jax.value_and_grad(trainer.d_loss_fn))(dp, p, batch)
    (_, g_metrics), g_grad = jax.jit(jax.value_and_grad(
        lambda q, d: trainer.loss_fn(q, batch, False, d), has_aux=True))(p, dp)
    g_upd, _ = jax.jit(tx.update)(g_grad, opt, p)
    d_upd, _ = jax.jit(tx_d.update)(d_grad, tx_d.init(dp), dp)
    out.update(d_loss=float(d_loss), d_grad=_np(d_grad), g_grad=_np(g_grad),
               g_metrics={k: float(v) for k, v in g_metrics.items()},
               g_next=_np(optax.apply_updates(p, g_upd)), d_next=_np(optax.apply_updates(dp, d_upd)),
               adam={"count": int(opt[0].count), "mu": _np(opt[0].mu), "nu": _np(opt[0].nu)})
    return out


def _noise_driven(trainer, batch):
    """The parameters whose gradient is zero but for rounding (a conv's
    bias under an instance norm): Adam scales that noise to a full step, in
    directions the two sides do not share, so their values are not held."""
    out = set()
    names = [n for n, _ in trainer.generator.named_parameters()]
    for warp in (True, False):
        loss, _ = trainer.loss_fn(batch, warp)
        grads = torch.autograd.grad(loss, list(trainer.generator.parameters()), allow_unused=True)
        top = max(float(g.abs().max()) for g in grads if g is not None)
        out |= {n for n, g in zip(names, grads) if g is not None and float(g.abs().max()) < 1e-6 * top}
    return out


def _assert_weights(got, ref, skip=()):
    """Each tensor within 2e-5, a fifth of one step's lr."""
    for k, v in ref.items():
        if k not in skip:
            np.testing.assert_allclose(np.asarray(got[k]), v, rtol=0, atol=2e-5, err_msg=k)


def _assert_state(gen, variables, skip=()):
    _assert_weights({k: v.numpy() for k, v in gen.state_dict().items()},
                    pirender_state_from_jax(variables), skip)


def _carry_adam(trainer, adam):
    """optax's Adam state (one count, mu, nu) into the trainer's torch Adam."""
    mu, nu = pirender_state_from_jax(adam["mu"]), pirender_state_from_jax(adam["nu"])
    for name, q in trainer.generator.named_parameters():
        trainer.optimizer.state[q] = {"step": torch.tensor(float(adam["count"])),
                                      "exp_avg": torch.from_numpy(mu[name]),
                                      "exp_avg_sq": torch.from_numpy(nu[name])}


def test_pirender_trainer_stages_match_optax(stages):
    """The warp and full stages: every step's metrics (1e-4), the weights
    after each stage within 2e-5, a fifth of one step's lr (not the biases
    whose gradient is rounding noise); the editing net moves only from the
    full stage on, and its first update is optax's (1 %), bias-corrected by
    the one step count that the warp steps advanced."""
    cfg, b = stages["cfg"], stages["batch"]
    batch = {"input_image": _nchw(b["input_image"]), "target_image": _nchw(b["target_image"]),
             "coeff_window": torch.from_numpy(b["coeff_window"]).transpose(1, 2)}
    tr = _port_trainer(cfg, stages["start"], stages["vgg_params"])
    noise = _noise_driven(tr, batch)
    assert 0 < len(noise) < 30 and all(k.endswith(".bias") for k in noise)
    edit0 = {k: v.clone() for k, v in tr.generator.state_dict().items()
             if k.startswith("editing_net.")}
    for i, ref in enumerate(stages["metrics"]):
        m = tr.train_step(batch, i < WARP_STEPS)
        assert set(m) == set(ref), i
        for k in ref:
            np.testing.assert_allclose(float(m[k]), ref[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i} {k}")
        if i + 1 == WARP_STEPS:
            _assert_state(tr.generator, stages["after"][i + 1], noise)
            for k, v in edit0.items():
                assert torch.equal(tr.generator.state_dict()[k], v), k
        if i + 1 == WARP_STEPS + 1:
            # the editing net's first update against optax's, replayed
            got = {k: tr.generator.state_dict()[k] - v for k, v in edit0.items()}
            ref_after = pirender_state_from_jax(stages["after"][i + 1])
            for k, v in edit0.items():
                if k in noise:
                    continue
                want = ref_after[k] - v.numpy()
                assert np.abs(got[k].numpy() - want).max() <= 0.01 * np.abs(want).max() + 1e-9, k
            # after 3 zero-gradient steps the shared count is 4: optax moves a
            # weight 1.066 lr (m_hat 0.533 g over sqrt(v_hat) 0.500 |g|); a
            # per-parameter count restarted at 1 would move it 1.000 lr
            big = max(float(got[k].abs().max()) for k in edit0)
            assert 1.06e-4 < big < 1.07e-4
    _assert_state(tr.generator, stages["after"][WARP_STEPS + FULL_STEPS], noise)


def test_pirender_trainer_gan_stage_matches_optax(stages):
    """The GAN stage from JAX's weights and Adam state at its start (its
    trajectories part through D, whose spectral sigma from the ones vectors
    is small): both objectives (1e-5) and their G and D gradients (1e-4 of
    each tensor's largest); G's step with the hinge GAN and feature
    matching, and D's step, each against optax's update (2e-5; not the
    tensors whose gradient is rounding noise)."""
    cfg, b = stages["cfg"], stages["batch"]
    batch = {"input_image": _nchw(b["input_image"]), "target_image": _nchw(b["target_image"]),
             "coeff_window": torch.from_numpy(b["coeff_window"]).transpose(1, 2)}
    at = stages["after"][WARP_STEPS + FULL_STEPS]
    d_state = discriminator_state_from_jax(stages["d_start"])
    same = _port_trainer(cfg, at, stages["vgg_params"], d_state)
    noise = _noise_driven(same, batch)
    np.testing.assert_allclose(float(same.d_loss_fn(batch)), stages["d_loss"], rtol=1e-5)
    loss, g_metrics = same.loss_fn(batch, False, use_gan=True)
    assert set(g_metrics) == set(stages["g_metrics"])
    for k, v in stages["g_metrics"].items():
        np.testing.assert_allclose(float(g_metrics[k]), v, rtol=1e-5, err_msg=k)
    names = [n for n, _ in same.generator.named_parameters()]
    grads = torch.autograd.grad(loss, list(same.generator.parameters()), allow_unused=True)
    ref = pirender_state_from_jax(stages["g_grad"])
    for n, g in zip(names, grads):
        if g is None:  # the reference's discarded branch: JAX's gradient is 0
            assert not np.any(ref[n]), n
        elif n not in noise:
            assert _rel(g.numpy(), ref[n]) < 1e-4, n
    same.d_loss_fn(batch).backward()
    ref = discriminator_state_from_jax(stages["d_grad"])
    top = max(float(np.abs(v).max()) for v in ref.values())
    # the spectral u, v under an instance norm: the loss sees sigma only
    # through the norm's eps, so their gradient is rounding noise (about
    # 2e-6 of the largest, against 0.3 and more for the weights)
    d_noise = {n for n, v in ref.items() if float(np.abs(v).max()) < 1e-4 * top}
    assert d_noise and all(n.endswith(("weight_u", "weight_v")) for n in d_noise)
    for n, q in same.discriminator.named_parameters():
        if n not in d_noise:
            assert _rel(q.grad.numpy(), ref[n]) < 1e-4, n
    # G's step from optax's state, then D's from the same generator weights
    g_step = _port_trainer(cfg, at, stages["vgg_params"], d_state)
    _carry_adam(g_step, stages["adam"])
    m = g_step.train_step(batch, False, use_gan=True)
    assert {"gan_g", "feature_matching"} <= set(m)
    _assert_state(g_step.generator, stages["g_next"], noise)
    d_step = _port_trainer(cfg, at, stages["vgg_params"], d_state)
    np.testing.assert_allclose(float(d_step.d_train_step(batch)), stages["d_loss"], rtol=1e-5)
    _assert_weights({k: v.numpy() for k, v in d_step.discriminator.state_dict().items()},
                    discriminator_state_from_jax(stages["d_next"]), d_noise)


def test_pirender_optimizer_is_optax_staircase_adam():
    """b1 0.5, b2 0.999 and the lr x0.2 every ``step_size`` updates."""
    g = np.linspace(-1, 1, 6).astype(np.float32)
    p = torch.nn.Parameter(torch.zeros(6))
    opt, sched = tpt.make_pirender_optimizer([p], 1e-2, step_size=2)
    tx = jpt.make_pirender_optimizer(1e-2, step_size=2)
    jparams, state = jnp.zeros(6), None
    state = tx.init(jparams)
    for i in range(5):
        grad = g * (i + 1)
        p.grad = torch.from_numpy(grad.copy())
        opt.step()
        sched.step()
        upd, state = tx.update(jnp.asarray(grad), state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams), rtol=1e-5, atol=1e-8)
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-2 * 0.2 ** 2)


def test_pirender_case_matches_golden(start):
    """The golden ``pirender`` entry (3 warp, then 3 full steps; rtol 2e-3,
    atol 1e-5, as test_golden.py) from golden_cases' start."""
    with open(GOLDEN) as f:
        golden = json.load(f)["pirender"]
    cfg, b, params, vgg_params = start
    tr = _port_trainer(cfg, params, vgg_params)
    batch = {"input_image": _nchw(b["input_image"]), "target_image": _nchw(b["target_image"]),
             "coeff_window": torch.from_numpy(b["coeff_window"]).transpose(1, 2)}
    got = {"warp_loss": [float(tr.train_step(batch, True)["loss"]) for _ in range(3)],
           "full_loss": [float(tr.train_step(batch, False)["loss"]) for _ in range(3)]}
    for key, want in golden.items():
        np.testing.assert_allclose(got[key], want, rtol=2e-3, atol=1e-5, err_msg=key)


# ---------------------------------------------------------------- data --


@pytest.fixture(scope="module")
def pair_root(tmp_path_factory):
    """Four 20-frame clips of two identities with 64^2 crops."""
    from test_torch_train_data import CLIPS, _write_clip

    root = tmp_path_factory.mktemp("pirender_pairs")
    rng = np.random.default_rng(0)
    for name in (CLIPS[0], CLIPS[1], CLIPS[3], CLIPS[4]):
        _write_clip(root, name, rng, "EMOCA_v2_lr_mse_20/processed_x/detections")
    return str(root)


@pytest.mark.parametrize("cross_id", [False, True])
def test_video_pair_dataset_matches_jax(pair_root, cross_id):
    """The same draws: samples and batches bit-equal at the crops' size;
    resized, within 2e-6 (the resize's float32 sums)."""
    j = jpairs.VideoPairDataset(root=pair_root, cross_id=cross_id, seed=3)
    t = tpairs.VideoPairDataset(root=pair_root, cross_id=cross_id, seed=3)
    assert len(t) == len(j) == 4 and t.person_ids == j.person_ids
    for _ in range(4):
        got, ref = t.sample(), j.sample()
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    got, ref = next(t.batches(3)), next(j.batches(3))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["coeff_window"].shape == (3, 27, 59)
    j = jpairs.VideoPairDataset(root=pair_root, cross_id=cross_id, seed=4, image_size=32)
    t = tpairs.VideoPairDataset(root=pair_root, cross_id=cross_id, seed=4, image_size=32)
    got, ref = t.sample(), j.sample()
    assert got["input_image"].shape == (32, 32, 3)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2e-6, err_msg=k)
    assert tpairs.obtain_seq_index(0, 20, 13) == jpairs.obtain_seq_index(0, 20, 13)


# ------------------------------------------------------------- command --


def test_cli_train_pirender_runs_on_cpu(pair_root, tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = ["train-pirender", "--tiny", "--device", "cpu", "--batch-size", "1", "--image-size",
            "16", "--log-every", "1"]
    assert main([*args, "--steps", "3", "--warp-steps", "1", "--gan", "--ckpt-dir", ck]) == 0
    out, err = capsys.readouterr()
    assert "synthetic pair batches" in err
    final = [x for x in out.splitlines() if x.startswith("final:")][0]
    for key in ("perceptual_warp", "perceptual_final", "gan_g", "feature_matching", "gan_d"):
        assert f"'{key}'" in final
    state = restore_checkpoint(ck)
    gen = tp.FaceGenerator(tp.PIRenderConfig.tiny())
    gen.load_state_dict(state["net_G"])
    td.MultiscaleDiscriminator(num_d=1, ndf=8, n_layers=2).load_state_dict(state["net_D"])
    fresh = tp.FaceGenerator.random_init(tp.PIRenderConfig.tiny(), device="cpu").state_dict()
    assert any(not torch.equal(v, fresh[k]) for k, v in state["net_G"].items())
    # --root (59-d windows) with --cross-id, warm-started by --net-g
    cfg59 = dataclasses.replace(tp.PIRenderConfig.tiny(), coeff_nc=59)
    net_g = str(tmp_path / "net_g.pt")
    ref = tp.FaceGenerator.random_init(cfg59, seed=7, device="cpu").state_dict()
    torch.save({"net_G_ema": {f"module.{k}": v for k, v in ref.items()}}, net_g)
    assert main([*args, "--steps", "2", "--warp-steps", "1", "--root", pair_root, "--cross-id",
                 "--net-g", net_g, "--ckpt-dir", ck]) == 0
    out = capsys.readouterr().out
    assert "video-pair data: 4 clips / 2 identities" in out
    got = restore_checkpoint(ck)["net_G"]
    moved = max(float((got[k] - v).abs().max()) for k, v in ref.items())
    assert 0 < moved < 1e-3  # two steps of lr 1e-4 from --net-g's weights


def test_cli_train_pirender_needs_a_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train-pirender", "--tiny", "--steps", "1"])
