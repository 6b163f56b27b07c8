"""Port parity, FLAME landmarks and the landmark terms: ``rot_mat_to_euler_y``,
``vertices2landmarks``, the dynamic contour's choice over a sweep of neck and
global y rotations (past +-39 degrees too), ``FlameModel.__call__`` with and
without the mediapipe set, the landmark losses (each < 1e-5 against JAX), and
three ``FaceFormerTrainer(flame=...)`` steps against JAX's trainer with
``optax.adamw`` on carried weights (< 1e-4, as the FaceFormer trainer test)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avi_talking_tpu.core import FlameModel as JFlame
from avi_talking_tpu.core import flame as jflame_mod
from avi_talking_tpu.core import rotations as jrot
from avi_talking_tpu.core import synthetic_assets as j_synthetic_assets
from avi_talking_tpu.models import faceformer as jff
from avi_talking_tpu.train import landmark_losses as jll
from avi_talking_tpu.train.faceformer_trainer import FaceFormerTrainer as JTrainer
from avi_talking_tpu_torch.cli.train import synthetic_batches
from avi_talking_tpu_torch.core import flame as tflame_mod
from avi_talking_tpu_torch.core import rotations as trot
from avi_talking_tpu_torch.core.assets import synthetic_assets as t_synthetic_assets
from avi_talking_tpu_torch.core.flame import FlameModel as TFlame
from avi_talking_tpu_torch.infra.jax_params import faceformer_state_from_jax
from avi_talking_tpu_torch.models import faceformer as tff
from avi_talking_tpu_torch.train import landmark_losses as tll
from avi_talking_tpu_torch.train.faceformer_trainer import FaceFormerTrainer
from avi_talking_tpu_torch.train.optim import adamw
from _torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
KW = dict(num_vertices=300, n_shape=8, n_exp=6, num_faces=200, seed=3, n_static_landmarks=51)


@pytest.fixture(scope="module")
def models():
    return (JFlame(j_synthetic_assets(**KW), n_shape=8, n_exp=6),
            TFlame(t_synthetic_assets(**KW), n_shape=8, n_exp=6))


def _close(got, ref, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=tol, rtol=tol, err_msg=what)


def test_rot_mat_to_euler_y_matches_jax():
    rng = np.random.default_rng(0)
    aa = rng.standard_normal((64, 3)).astype(np.float32)
    R = np.array(jrot.batch_rodrigues(jnp.asarray(aa)))
    _close(trot.rot_mat_to_euler_y(torch.from_numpy(R)), jrot.rot_mat_to_euler_y(jnp.asarray(R)))


@pytest.mark.parametrize("batched", [False, True])
def test_vertices2landmarks_matches_jax(models, batched):
    jm, _ = models
    rng = np.random.default_rng(1)
    B, L = 3, 20
    verts = rng.standard_normal((B, KW["num_vertices"], 3)).astype(np.float32)
    faces = np.asarray(jm.assets.faces)
    idx = rng.integers(0, faces.shape[0], (B, L) if batched else (L,)).astype(np.int32)
    bary = rng.random(idx.shape + (3,)).astype(np.float32)
    ref = jflame_mod.vertices2landmarks(jnp.asarray(verts), jnp.asarray(faces),
                                        jnp.asarray(idx), jnp.asarray(bary))
    got = tflame_mod.vertices2landmarks(*(torch.from_numpy(a) for a in (verts, faces, idx, bary)))
    assert got.shape == (B, L, 3)
    _close(got, ref)


def _pose_sweep():
    """Full poses (N, 15) whose neck chain turns about y by global + neck
    angles from -60 to 60 degrees, half-degree edges and +-39 included."""
    deg = np.concatenate([np.arange(-60, 61, 7.5), [-39.5, -39, -38.5, 38.5, 39, 39.5, 0.5,
                                                    -0.5, 20.5]])
    pairs = [(g, n) for g in deg for n in (0.0, 12.25, -30.0)]
    fp = np.zeros((len(pairs), 15), np.float32)
    for i, (g, n) in enumerate(pairs):
        fp[i, 1] = np.deg2rad(g)
        fp[i, 4] = np.deg2rad(n)
        fp[i, 0] = 0.05  # a little x rotation, so the chain is not a pure y turn
    return fp


def test_dynamic_landmarks_match_jax_over_a_y_sweep(models):
    jm, tm = models
    fp = _pose_sweep()
    jidx, jbary = jm._dynamic_landmarks(jnp.asarray(fp))
    tidx, tbary = tm._dynamic_landmarks(torch.from_numpy(fp))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tbary.numpy(), np.asarray(jbary))
    # the sweep reaches both ends of the table: the clip at 39 and the 78 row
    rows = {tuple(r) for r in np.asarray(jm.assets.dynamic_lmk_faces_idx)[[39, 78]]}
    assert {tuple(r) for r in tidx.numpy()} >= rows


@pytest.mark.parametrize("with_mediapipe", [False, True])
def test_flame_call_matches_jax(models, with_mediapipe):
    jm, tm = models
    jm = dataclasses.replace(jm, with_mediapipe=with_mediapipe)
    tm = dataclasses.replace(tm, with_mediapipe=with_mediapipe)
    rng = np.random.default_rng(2)
    B = 5
    shape = rng.standard_normal((B, 8)).astype(np.float32)
    exp = rng.standard_normal((B, 6)).astype(np.float32)
    pose = (rng.standard_normal((B, 6)) * 0.4).astype(np.float32)
    eyes = (rng.standard_normal((B, 6)) * 0.1).astype(np.float32)
    ref = jm(*(jnp.asarray(a) for a in (shape, exp, pose, eyes)))
    got = tm(*(torch.from_numpy(a) for a in (shape, exp, pose, eyes)))
    assert len(got) == len(ref) == (4 if with_mediapipe else 3)
    assert got[1].shape == (B, 68, 3)
    for g, r, name in zip(got, ref, ("vertices", "landmarks2d", "landmarks3d", "mediapipe")):
        _close(g, r, what=name)


@pytest.mark.parametrize("name", ["eye_dis", "lip_dis", "mouth_corner_dis", "eyed_loss",
                                  "lipd_loss", "mouth_corner_loss", "landmark_loss",
                                  "weighted_landmark_loss"])
def test_landmark_losses_match_jax(name):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 68, 3)).astype(np.float32)
    b = rng.standard_normal((3, 68, 3)).astype(np.float32)
    jf, tf = getattr(jll, name), getattr(tll, name)
    args = (a,) if name.endswith("_dis") else (a, b)
    _close(tf(*(torch.from_numpy(x) for x in args)), jf(*(jnp.asarray(x) for x in args)),
           what=name)


def test_three_landmark_steps_match_optax():
    """``FaceFormerTrainer`` with FLAME's landmark terms (68 points, the
    coefficients de-normalised by non-trivial statistics, the eye term on):
    the loss and its terms at each step and every parameter after three
    AdamW steps, < 1e-4 against JAX's trainer with ``optax.adamw(1e-4)``."""
    cfg = jff.FaceFormerConfig.tiny()
    tcfg = tff.FaceFormerConfig.tiny()
    assert tcfg.vertice_dim == 6 + 3  # exp 6 + jaw 3 of the landmark FLAME
    batches = synthetic_batches(tcfg, 2, 8, seed=0, device="cpu")
    batches = [next(batches) for _ in range(3)]
    jb = [{k: v.numpy() for k, v in b.items()} for b in batches]
    rng = np.random.default_rng(1)
    mean = (rng.standard_normal(9) * 0.1).astype(np.float32)
    std = (0.5 + rng.random(9)).astype(np.float32)
    kw = dict(num_vertices=128, n_shape=8, n_exp=6, num_faces=64, n_static_landmarks=51)
    weights = dict(ldmk_weight=10.0, lipd_weight=1.0, eyed_weight=0.5)

    jm = jff.FaceFormerCoeff(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jb[0]["audio"], jb[0]["coeff"],
                              jb[0]["eye_embed"], jb[0]["emo_embed"], jb[0]["ref_coeff"])
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.05).astype(np.float32), params)
    tm = tff.FaceFormerCoeff.random_init(tcfg, device="cpu")
    tm.load_state_dict({k: torch.as_tensor(v)
                        for k, v in faceformer_state_from_jax(params["params"]).items()})
    trainer = FaceFormerTrainer(model=tm, optimizer=adamw(tm.parameters(), 1e-4),
                                flame=TFlame(t_synthetic_assets(**kw), n_shape=8, n_exp=6),
                                coeff_mean=torch.from_numpy(mean),
                                coeff_std=torch.from_numpy(std), **weights)
    tx = optax.adamw(1e-4)
    jt = JTrainer(model=jm, tx=tx, flame=JFlame(j_synthetic_assets(**kw), n_shape=8, n_exp=6),
                  coeff_mean=jnp.asarray(mean), coeff_std=jnp.asarray(std), **weights)
    step = jax.jit(jt.train_step)
    opt = tx.init(params)
    for i in range(3):
        params, opt, jmetrics = step(params, opt, jb[i], jax.random.PRNGKey(i))
        metrics = trainer.train_step(batches[i])
        assert set(metrics) == set(jmetrics) == {"coeff", "ldmk", "loss"}
        assert float(jmetrics["ldmk"]) > 0
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), atol=1e-4, rtol=0,
                                       err_msg=f"step {i} {k}")
    ref = faceformer_state_from_jax(jax.tree.map(np.asarray, params["params"]))
    got = tm.state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=1e-4, rtol=0, err_msg=k)


def test_landmark_terms_need_68_points():
    tcfg = tff.FaceFormerConfig.tiny()
    tm = tff.FaceFormerCoeff.random_init(tcfg, device="cpu")
    small = TFlame(t_synthetic_assets(n_shape=8, n_exp=6), n_shape=8, n_exp=6)  # 17 + 16 points
    trainer = FaceFormerTrainer(model=tm, optimizer=adamw(tm.parameters(), 1e-4), flame=small)
    with pytest.raises(ValueError, match="68-point"):
        trainer.loss_fn(next(synthetic_batches(tcfg, 2, 8, seed=0, device="cpu")))
