"""Port parity of the EMOTE neural-loss stage: ``TalkingHeadTrainer`` with
``NeuralLosses`` (renders at 24^2, the lip-reading, EmoNet and
video-emotion towers carried from JAX by ``infra.jax_params``) and the
condition exchange, against JAX's trainer with ``optax.adamw`` on the same
tiny head, batch and permutations (``tests/test_talking_head_neural.py``'s
sizes); the command ``train-emote --neural``.

The batch is the command's synthetic kind: one-hot expressions over 9
classes (one row is class 8, past the classifiers' 8, a row that adds 0 to
the video-emotion cross-entropy) and gt coefficients without gt vertices,
which both trainers decode in the loss after the geometric terms.
Tolerances: each loss term 1e-4 relative; the weights 1e-4 after three
steps, the key biases of each attention (exact gradient 0) 2·lr a step
(``test_torch_emote_train._assert_state_matches``)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avi_talking_tpu.core import assets as jassets
from avi_talking_tpu.models.conditioning import StyleCondition as JCond
from avi_talking_tpu.models.emoca import EmoNetLoss as JEmoNetLoss
from avi_talking_tpu.models.emoca import EmotionRecognitionModule as JEmo
from avi_talking_tpu.models.emote import EmoteConfig as JConfig
from avi_talking_tpu.models.emote import EmoteTalkingHead as JHead
from avi_talking_tpu.models.lipread import LipReadingLoss as JLipLoss
from avi_talking_tpu.models.lipread import LipReadingNet as JLip
from avi_talking_tpu.models.video_emotion import VideoEmotionClassifier as JVemo
from avi_talking_tpu.models.video_emotion import VideoEmotionLoss as JVemoLoss
from avi_talking_tpu.train.eval_metrics import condition_exchange as j_exchange
from avi_talking_tpu.train.talking_head import NeuralLosses as JNeural
from avi_talking_tpu.train.talking_head import TalkingHeadTrainer as JTrainer
from avi_talking_tpu.viz.visualizer import FixedViewRenderer as JRenderer
from avi_talking_tpu_torch.cli import main
from avi_talking_tpu_torch.core import assets as tassets
from avi_talking_tpu_torch.infra import jax_params
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.models.emoca import EmoNetLoss, EmotionRecognitionModule
from avi_talking_tpu_torch.models.emote import EmoteConfig
from avi_talking_tpu_torch.models.lipread import LipReadingLoss, LipReadingNet
from avi_talking_tpu_torch.models.video_emotion import VideoEmotionClassifier, VideoEmotionLoss
from avi_talking_tpu_torch.train.optim import adamw
from avi_talking_tpu_torch.train.talking_head import (
    NeuralLosses,
    TalkingHeadTrainer,
    emote_trainables,
)
from avi_talking_tpu_torch.viz.visualizer import FixedViewRenderer
from test_torch_emote_train import _assert_state_matches, _port

NEURAL_TERMS = ("loss_lipread", "loss_emotion", "loss_video_emotion",
                "loss_lipread_disentangled", "loss_emotion_disentangled",
                "loss_video_emotion_disentangled")
CPU = torch.device("cpu")
VEMO = dict(n_classes=8, feature_dim=16, num_layers=1, nhead=2, input_dim=2048)
LR = 1e-4


def _batch(cfg, B=2, seed=0, labels=(8, 2)):
    """The command's synthetic kind of batch, at the tiny size (2 latent
    frames), without gt vertices."""
    T = 2 * cfg.flint.latent_frame_size
    d = np.random.default_rng(seed)
    return {
        "raw_audio": d.standard_normal((B, T, 640)).astype(np.float32),
        "expression": np.eye(9, dtype=np.float32)[list(labels)],
        "intensity": np.eye(3, dtype=np.float32)[[0, 2]],
        "identity": np.eye(32, dtype=np.float32)[[3, 9]],
        "shape": np.zeros((B, cfg.n_shape), np.float32),
        "gt_exp": d.standard_normal((B, T, cfg.flint.n_exp)).astype(np.float32) * 0.1,
        "gt_jaw": np.abs(d.standard_normal((B, T, 3))).astype(np.float32) * 0.05,
    }


def _np(x):
    return jax.tree.map(np.asarray, x)


def _suites():
    """JAX's ``_neural_suite`` (towers at init from PRNGKey(7)) and the
    port's, with the same weights; both render at 24^2."""
    cfg = JConfig.tiny()
    faces = np.array(jassets.synthetic_assets(n_shape=cfg.n_shape, n_exp=cfg.flint.n_exp).faces)
    key = jax.random.PRNGKey(7)
    lip_net, emo_mod, vemo = JLip(), JEmo(n_expression=8), JVemo(**VEMO)
    lip_vars = jax.jit(lip_net.init)(key, jnp.zeros((1, 2, 24, 24, 1)))
    emo_vars = jax.jit(emo_mod.init)(key, jnp.zeros((1, 24, 24, 3)))
    vemo_vars = jax.jit(vemo.init)(key, jnp.zeros((1, 4, 2048)))
    jn = JNeural(renderer=JRenderer(faces, image_size=24),
                 lipread=JLipLoss(lip_net, lip_vars), lipread_weight=1.0,
                 emonet=JEmoNetLoss(emo_mod), emonet_variables=emo_vars, emotion_weight=1.0,
                 video_emotion=JVemoLoss(vemo, vemo_vars), video_emotion_weight=0.1)

    def port(factory, state):
        m = random_module(factory, CPU, torch.Generator().manual_seed(0))
        m.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        return m

    tn = NeuralLosses(
        renderer=FixedViewRenderer(faces, image_size=24, device="cpu"),
        lipread=LipReadingLoss(port(LipReadingNet, jax_params.lipread_state_from_jax(
            _np(lip_vars)))), lipread_weight=1.0,
        emonet=EmoNetLoss(port(lambda: EmotionRecognitionModule(n_expression=8),
                               jax_params.emotion_module_state_from_jax(_np(emo_vars)))),
        emotion_weight=1.0,
        video_emotion=VideoEmotionLoss(port(lambda: VideoEmotionClassifier(**VEMO),
                                            jax_params.video_emotion_state_from_jax(
                                                _np(vemo_vars)["params"]))),
        video_emotion_weight=0.1)
    return jn, tn


@pytest.fixture(scope="module")
def suites():
    return _suites()


@pytest.fixture(scope="module")
def jax_head():
    """The tiny JAX head with FLAME assets and its variables at PRNGKey(0)."""
    batch = _batch(JConfig.tiny())
    jcfg = JConfig.tiny()
    jm = JHead(jcfg, flame_assets=jassets.synthetic_assets(n_shape=jcfg.n_shape,
                                                            n_exp=jcfg.flint.n_exp))
    cond = JCond(*(jnp.asarray(batch[k]) for k in ("expression", "intensity", "identity",
                                                   "shape")))
    variables = jax.jit(lambda k, a: jm.init(k, a, cond))(jax.random.PRNGKey(0),
                                                          jnp.asarray(batch["raw_audio"]))
    return jm, variables


def _port_head(variables):
    """The port's tiny head with FLAME assets and the JAX head's weights."""
    cfg = EmoteConfig.tiny()
    return _port(cfg, variables, 9 + 3 + 32 + cfg.n_shape,
                 tassets.synthetic_assets(n_shape=cfg.n_shape, n_exp=cfg.flint.n_exp))


@pytest.fixture(scope="module")
def three_steps(suites, jax_head):
    """Three AdamW steps of both trainers with the neural suite and the
    condition exchange; JAX's step i draws from PRNGKey(i), whose exchange
    permutation the port is given."""
    jn, tn = suites
    batch = _batch(JConfig.tiny())
    jm, variables = jax_head
    tm = _port_head(variables)
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    tx = optax.adamw(LR)
    step = jax.jit(JTrainer(head=jm, tx=tx, neural=jn,
                            disentangle="condition_exchange").train_step)
    opt = tx.init(variables)
    trainer = TalkingHeadTrainer(head=tm, optimizer=adamw(emote_trainables(tm), LR), neural=tn,
                                 disentangle="condition_exchange")
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jms, tms = [], []
    for i in range(3):
        rng = jax.random.PRNGKey(i)
        perm = torch.from_numpy(np.asarray(j_exchange(jb, rng)[1]).astype(np.int64))
        variables, opt, jmet = step(variables, opt, jb, rng)
        jms.append({k: float(v) for k, v in jmet.items()})
        tms.append({k: float(v) for k, v in trainer.train_step(tb, perm=perm).items()})
    return {"jax": jms, "port": tms, "tm": tm, "variables": variables, "start": start}


def test_neural_terms_match_jax(three_steps):
    """Every metric at each of three steps, the six neural terms and the
    total among them, within 1e-4 relative; the batch has no gt_vertices,
    so neither trainer reports a vertex term (the decode comes after the
    geometric losses)."""
    for i, (jm, tm) in enumerate(zip(three_steps["jax"], three_steps["port"])):
        assert set(tm) == set(jm)
        assert set(NEURAL_TERMS) <= set(tm) and "loss_vertex" not in tm
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=0, err_msg=f"step {i} {k}")
        assert all(tm[k] != 0.0 for k in NEURAL_TERMS)
    first = three_steps["port"][0]
    assert first["loss_lipread_disentangled"] != first["loss_lipread"]


def test_neural_steps_parameters_match_jax(three_steps):
    """Every weight and BatchNorm statistic of the head after three steps
    (1e-4; the key biases 2·lr a step); the steps moved the weights."""
    tm = three_steps["tm"]
    _assert_state_matches(tm, three_steps["variables"], 3, LR)
    got, start = tm.state_dict(), three_steps["start"]
    assert max(float((got[k] - start[k]).abs().max()) for k in start) > 2e-4


def test_towers_stay_frozen_and_outside_the_optimizer(suites, three_steps):
    """The towers take no gradient and are not trained: eval mode, no
    parameter requires grad, none is among ``emote_trainables``."""
    _, tn = suites
    towers = [tn.lipread.net, tn.emonet.module, tn.video_emotion.classifier]
    trained = {id(t) for t in emote_trainables(three_steps["tm"])}
    for tower in towers:
        assert not tower.training
        for p in tower.parameters():
            assert not p.requires_grad and p.grad is None and id(p) not in trained


def test_vertex_gradient_flows_through_render_and_towers(suites):
    """d(neural loss) / d(predicted vertices) is finite and not zero: the
    gradient reaches the vertices through the frozen towers and the
    rasterizer's interpolation."""
    _, tn = suites
    cfg = EmoteConfig.tiny()
    assets = tassets.synthetic_assets(n_shape=cfg.n_shape, n_exp=cfg.flint.n_exp)
    rng = np.random.default_rng(3)
    v0 = assets.v_template.numpy()
    gt = torch.from_numpy(v0[None, None] + rng.standard_normal((2, 3) + v0.shape).astype(
        np.float32) * 0.01)
    pred = (gt + torch.from_numpy(rng.standard_normal(gt.shape).astype(np.float32)) * 0.01)
    pred.requires_grad_()
    batch = {"expression": torch.from_numpy(np.eye(9, dtype=np.float32)[[1, 8]])}
    metrics = {}
    tn.loss(pred, gt, batch, 2, None, metrics).backward()
    assert set(metrics) == {"loss_lipread", "loss_emotion", "loss_video_emotion"}
    assert torch.isfinite(pred.grad).all() and float(pred.grad.abs().max()) > 0


def test_neural_losses_off_by_default(jax_head):
    """Without ``neural`` no render term is computed or reported."""
    batch = _batch(JConfig.tiny())
    tm = _port_head(jax_head[1])
    trainer = TalkingHeadTrainer(head=tm, optimizer=adamw(emote_trainables(tm), LR))
    metrics = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert not any(t in metrics for t in NEURAL_TERMS) and "loss_vertex" not in metrics
    assert np.isfinite(float(metrics["loss"]))


def test_condition_exchange_geometric_loss_on_original_half(suites, jax_head):
    """Doubling the batch with exchanged styles leaves loss_exp as the
    plain batch's at the same weights (the geometric terms read rows :B),
    with the neural suite on."""
    _, tn = suites
    batch = {k: torch.from_numpy(v) for k, v in _batch(JConfig.tiny(), seed=4).items()}
    tm = _port_head(jax_head[1])
    opt = adamw(emote_trainables(tm), LR)
    plain = TalkingHeadTrainer(head=tm, optimizer=opt)
    doubled = TalkingHeadTrainer(head=tm, optimizer=opt, neural=tn,
                                 disentangle="condition_exchange")
    with torch.no_grad():
        m_plain = plain.loss_fn(batch)[1]
        m_doubled = doubled.loss_fn(batch, perm=torch.tensor([1, 0]))[1]
    np.testing.assert_allclose(float(m_plain["loss_exp"]), float(m_doubled["loss_exp"]),
                               rtol=1e-5)
    assert set(NEURAL_TERMS) <= set(m_doubled)


def test_cli_train_emote_neural_runs_on_cpu(tmp_path, capsys):
    """``train-emote --neural --tiny --device cpu --steps 1``: two stages,
    the second with the neural terms, validated and logged (every logged
    value is finite), with the RANDOM-init warning."""
    run = tmp_path / "run"
    assert main(["train-emote", "--neural", "--tiny", "--device", "cpu", "--steps", "1",
                 "--frames", "16", "--val-every", "1", "--run-dir", str(run)]) == 0
    out, err = capsys.readouterr()
    assert "done: 2 steps" in out and "RANDOM-init" in err
    logged = {}
    for line in open(run / "logs" / "scalars.jsonl"):
        logged.update(json.loads(line))
    for term in NEURAL_TERMS + ("loss",):
        assert f"emote_val/disentangled/{term}" in logged, term
        assert np.isfinite(logged[f"emote_val/disentangled/{term}"])
    assert not any(k.startswith("emote_val/geometric/loss_lip") for k in logged)
