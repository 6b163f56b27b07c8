"""Port parity of EMOCA / DECA's coarse training: three steps against
JAX's jitted step (the terms, the gradients, the updated weights),
``--exp-only`` (``E_flame`` bit-unchanged, ``E_expression`` as in the full
step) and the emotion term by the value of JAX's jitted ``loss_fn``. S=32,
B=2, the tiny FLAME. The detail stage and the commands are in
``test_torch_emoca_detail.py``.

The port's seeded weights go to JAX through JAX's reference importers;
each JAX computation is compiled once, in a module-scoped fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avi_talking_tpu.core import FlameModel as JFlame
from avi_talking_tpu.core import synthetic_assets as jsynthetic
from avi_talking_tpu.models import emoca as jemoca
from avi_talking_tpu.train import deca_losses as jdl
from avi_talking_tpu.train import emoca_trainer as jet
from avi_talking_tpu_torch.core.assets import synthetic_assets
from avi_talking_tpu_torch.core.flame import FlameModel
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.infra.jax_params import emoca_encoder_state_from_jax as _flat
from avi_talking_tpu_torch.models import emoca as temoca
from avi_talking_tpu_torch.train import deca_losses as tdl
from avi_talking_tpu_torch.train import emoca_trainer as tet
from _torch_threads import one_torch_thread  # noqa: F401

S, B, LR, STEPS = 32, 2, 1e-4, 3
CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_state(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _assets():
    return synthetic_assets(n_shape=8, n_exp=6, n_static_landmarks=51)


def _uv(template):
    t = np.asarray(template)
    return (((t - t.min(0)) / (t.max(0) - t.min(0) + 1e-6))[:, :2]).astype(np.float32)


def _batch(seed):
    d = np.random.default_rng(seed)
    return {"images": d.uniform(0, 1, (B, S, S, 3)).astype(np.float32),
            "lmk": d.uniform(-0.8, 0.8, (B, 68, 2)).astype(np.float32)}


def _encoder(with_detail=False):
    return random_module(lambda: temoca.EmocaEncoder(n_exp=6, with_detail=with_detail, n_detail=4),
                         CPU, torch.Generator().manual_seed(7))


def _jax_flame():
    assets = jsynthetic(n_shape=8, n_exp=6, n_static_landmarks=51)
    return assets, JFlame(assets, n_shape=8, n_exp=6)


def _jax_step(loss_fn):
    tx = optax.adam(LR)

    @jax.jit
    def step(params, opt, static, batch):
        (loss, terms), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, static, batch)
        upd, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, upd), opt, dict(terms, total=loss), grads
    return tx, step


def _grads_close(got, want, rel=1e-3):
    """Each gradient within ``rel`` of the model's largest (JAX's)."""
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k, g in got.items():
        assert float(np.abs(g - want[k]).max()) <= rel * scale, k


# ---------------------------------------------------------------- coarse --


@pytest.fixture(scope="module")
def coarse_case():
    """JAX's coarse trainer from the port's seeded encoder: STEPS steps on
    the golden case's batch (terms, first gradients, final params)."""
    enc = _encoder()
    jvars = jemoca.emoca_encoder_params_from_torch(_np_state(enc))
    assets, flame = _jax_flame()
    trainer = jet.EmocaTrainer(encoder=jemoca.EmocaEncoder(n_exp=6), flame=flame,
                               uv_coords=jnp.asarray(_uv(assets.v_template)),
                               uv_faces=assets.faces, image_size=S, raster_chunk=256)
    tx, step = _jax_step(trainer.loss_fn)
    params = jvars["params"]
    static = {"batch_stats": jvars["batch_stats"]}
    opt = tx.init(params)
    batch = {k: jnp.asarray(v) for k, v in _batch(0).items()}
    terms, grads = [], None
    for i in range(STEPS):
        params, opt, t, g = step(params, opt, static, batch)
        terms.append({k: float(v) for k, v in t.items()})
        grads = grads or jax.tree.map(np.asarray, g)
    return dict(terms=terms,
                grads=_flat({"params": grads, "batch_stats": jvars["batch_stats"]}),
                params=_flat({"params": jax.tree.map(np.asarray, params),
                              "batch_stats": jvars["batch_stats"]}))


def _port_trainer(enc, **kw):
    assets = _assets()
    return tet.EmocaTrainer(encoder=enc, flame=FlameModel(assets, n_shape=8, n_exp=6),
                            uv_coords=_t(_uv(assets.v_template)), uv_faces=assets.faces,
                            image_size=S, raster_chunk=256, **kw)


def _port_batch(seed=0):
    return {k: _t(v) for k, v in _batch(seed).items()}


def test_coarse_steps_match_jax(coarse_case):
    enc = _encoder()
    trainer = _port_trainer(enc)
    opt = trainer.make_optimizer(LR)
    batch = _port_batch()
    for i in range(STEPS):
        if i == 0:  # the first step's gradients, against jax.grad's
            opt.zero_grad()
            total, _ = trainer.loss_fn(batch)
            total.backward()
            named = dict(enc.named_parameters())
            _grads_close({k: p.grad.numpy() for k, p in named.items()},
                         {k: v for k, v in coarse_case["grads"].items() if k in named})
            opt.zero_grad()
        terms = trainer.train_step(opt, batch)
        want = coarse_case["terms"][i]
        assert set(terms) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(terms[k]), v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i + 1} {k}")
    # after three Adam steps each weight lies within 2 lr of JAX's (where a
    # gradient's sign flips between the sides, Adam's step is lr the other way)
    state = enc.state_dict()
    moved = 0
    for k, want in coarse_case["params"].items():
        got = state[k].numpy()
        assert np.abs(got - want).max() <= 2 * LR * STEPS, k
        moved += int((np.abs(got - want) > 1e-6).sum())
    n = sum(v.size for v in coarse_case["params"].values())
    assert moved <= 1e-3 * n, (moved, n)


def test_exp_only_freezes_e_flame(coarse_case):
    """``--exp-only``: E_flame stays bit-unchanged; E_expression takes the
    full step's update (its Adam state and gradient are its own)."""
    enc = _encoder()
    flame0 = {k: v.clone() for k, v in enc.E_flame.state_dict().items()}
    trainer = _port_trainer(enc, train_exp_only=True)
    opt = trainer.make_optimizer(LR)
    trainer.train_step(opt, _port_batch())
    for k, v in enc.E_flame.state_dict().items():
        assert torch.equal(v, flame0[k]), k
    full = _encoder()
    ftrainer = _port_trainer(full)
    ftrainer.train_step(ftrainer.make_optimizer(LR), _port_batch())
    for k, v in enc.E_expression.state_dict().items():
        torch.testing.assert_close(v, full.E_expression.state_dict()[k], rtol=0, atol=1e-7)
    assert not torch.equal(enc.E_expression.layers[2].weight,
                           _encoder().E_expression.layers[2].weight)


def test_emotion_term_matches_jax():
    """``--emo-loss``: the coarse loss with EMOCA's emotion term, by the
    value of JAX's jitted ``loss_fn`` on the same encoder and EmoNet."""
    enc = _encoder()
    emo = random_module(lambda: temoca.EmotionRecognitionModule(8), CPU,
                        torch.Generator().manual_seed(9)).requires_grad_(False)
    jvars = jemoca.emoca_encoder_params_from_torch(_np_state(enc))
    assets, flame = _jax_flame()
    jtrainer = jet.EmocaTrainer(
        encoder=jemoca.EmocaEncoder(n_exp=6), flame=flame,
        uv_coords=jnp.asarray(_uv(assets.v_template)), uv_faces=assets.faces, image_size=S,
        raster_chunk=256, weights=jdl.DecaLossWeights(emonet=1.0),
        emonet=jemoca.EmoNetLoss(jemoca.EmotionRecognitionModule(n_expression=8)),
        emonet_variables=jemoca.emotion_module_params_from_torch(_np_state(emo)))
    batch = _batch(1)
    _, jterms = jax.jit(jtrainer.loss_fn)(jvars["params"], {"batch_stats": jvars["batch_stats"]},
                                          {k: jnp.asarray(v) for k, v in batch.items()})
    trainer = _port_trainer(enc, weights=tdl.DecaLossWeights(emonet=1.0),
                            emonet=temoca.EmoNetLoss(emo))
    with torch.no_grad():
        _, terms = trainer.loss_fn({k: _t(v) for k, v in batch.items()})
    assert "emotion" in terms and float(jterms["emotion"]) > 0
    for k, v in jterms.items():
        np.testing.assert_allclose(float(terms[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
