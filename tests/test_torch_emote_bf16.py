"""Port parity of ``train-emote --bf16``: the EMOTE head and the perception
towers at a bfloat16 compute dtype over float32 weights, under the gradient.

Each case runs the same weights and inputs through JAX at float32 and at
bfloat16 and through the port at bfloat16, and holds the rule of
``test_torch_bf16.assert_closer``: the port's bfloat16 result is closer to
JAX's bfloat16 result than JAX's bfloat16 result is to its float32 one
(root mean square distances); where the port is bit-equal to JAX's
bfloat16, that is asserted too. JAX's bfloat16 side is compiled with
``xla_allow_excess_precision`` off, so each op rounds as its dtype says.

* K1's bfloat16 backward (the float32 recompute, cast to the inputs'
  dtypes) against ``jax.vjp`` of ``keybias_attention(interpret=True)`` on
  bfloat16 inputs, within ``kb.bf16_disagreement``'s limit on dq, dk, dv
  and the key bias's gradient.
* The four towers (lip reading, ResNet-50's features, EmoNet's heads, the
  video-emotion classifier) on the frames of a float32 render, and the six
  neural terms with their gradient at the predicted vertices (JAX's
  ``_neural_losses``). The towers' weights are seeded port modules carried
  to JAX by the JAX package's own importers, with their BatchNorms' scales,
  shifts and statistics drawn away from the identity. The neural graphs are
  compiled at XLA's backend optimisation level 0 (only to compile faster).
* Three ``TalkingHeadTrainer`` steps of the tiny head (``adamw(1e-4)``)
  from the same weights and batch: the first step's gradients, every
  metric of the three steps, and the weights after them. Past the first
  step the runs are chaotic at bfloat16: AdamW moves each weight by about
  lr along its gradient's sign, so a flipped rounding anywhere changes the
  next forward, and JAX's own bfloat16 step compiled with excess precision
  on (XLA's default) lies farther from the one compiled without it than
  the port does (weights 4.4e-5 against 2.5e-5, metrics 0.032 against
  0.019 rms). The key biases of each attention have an exact gradient of
  0 (softmax is shift invariant along a key row): their gradient is
  rounding noise, held out of the rule, and their weights within 2·lr a
  step (two right AdamW steps may move such a weight by lr apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avi_talking_tpu.core import assets as jassets
from avi_talking_tpu.models.emoca import EmoNetLoss as JEmoNetLoss
from avi_talking_tpu.models.emoca import EmotionRecognitionModule as JEmo
from avi_talking_tpu.models.emoca import emotion_module_params_from_torch
from avi_talking_tpu.models.emote import EmoteConfig as JConfig
from avi_talking_tpu.models.emote import EmoteTalkingHead as JHead
from avi_talking_tpu.models.lipread import LipReadingLoss as JLipLoss
from avi_talking_tpu.models.lipread import LipReadingNet as JLip
from avi_talking_tpu.models.lipread import lipread_params_from_torch
from avi_talking_tpu.models.video_emotion import VideoEmotionClassifier as JVemo
from avi_talking_tpu.models.video_emotion import VideoEmotionLoss as JVemoLoss
from avi_talking_tpu.ops.pallas.attention import keybias_attention as jkeybias
from avi_talking_tpu.train.talking_head import NeuralLosses as JNeural
from avi_talking_tpu.train.talking_head import TalkingHeadTrainer as JTrainer
from avi_talking_tpu.viz.visualizer import FixedViewRenderer as JRenderer
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.infra.jax_params import (
    emote_head_state_from_jax,
    video_emotion_state_from_jax,
)
from avi_talking_tpu_torch.models.emoca import EmoNetLoss, EmotionRecognitionModule
from avi_talking_tpu_torch.models.emote import EmoteConfig, EmoteTalkingHead
from avi_talking_tpu_torch.models.lipread import LipReadingLoss, LipReadingNet
from avi_talking_tpu_torch.models.video_emotion import VideoEmotionClassifier, VideoEmotionLoss
from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb
from avi_talking_tpu_torch.ops.layers import BatchNorm2d, BatchNorm3d
from avi_talking_tpu_torch.train.optim import adamw
from avi_talking_tpu_torch.train.talking_head import (
    NeuralLosses,
    TalkingHeadTrainer,
    emote_trainables,
)
from avi_talking_tpu_torch.viz.visualizer import FixedViewRenderer
from test_torch_bf16 import _f32, _rms, assert_closer
from test_torch_emote_train import _batch, _init
from _torch_threads import one_torch_thread  # noqa: F401

BF = jnp.bfloat16
CPU = torch.device("cpu")
LR = 1e-4
VEMO = dict(n_classes=8, feature_dim=32, num_layers=1, nhead=4, input_dim=2048)
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args, exact=False, options=()):
    opts = dict(options)
    if exact:
        opts["xla_allow_excess_precision"] = False
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)(*args)


def _noise_free(name: str) -> bool:
    """False for the key biases, whose exact gradient is 0."""
    return not name.endswith("k_proj.bias")


def _flat(state, names):
    """The named tensors in one float64 vector, the middle (key) third of
    each packed ``in_proj_bias`` left out."""
    out = []
    for k in names:
        v = np.asarray(_f32(state[k]), np.float64).ravel()
        if k.endswith("in_proj_bias"):
            d = v.shape[0] // 3
            v = np.concatenate([v[:d], v[2 * d:]])
        out.append(v)
    return np.concatenate(out)


# ------------------------------------------------------- K1 backward --


@pytest.mark.parametrize("B,H,T,S,d,lens", [
    (2, 4, 16, 16, 64, (16, 11)),  # EMOTE's head width, a padded clip
    (1, 2, 24, 40, 32, (29,)),  # T != S
])
def test_keybias_bf16_backward_matches_jax_vjp(B, H, T, S, d, lens):
    """The gradients of q, k, v and the key bias at bfloat16 against JAX's
    custom_vjp (``_keybias_bwd``) over the Pallas kernel in interpret mode,
    each within ``kb.bf16_disagreement``'s limit: both recompute the softmax
    in float32 and round each gradient once, so they differ only where a
    float32 sum in another order rounds the other way."""
    rng = np.random.default_rng(B * 10 + S)
    q = jnp.asarray(rng.standard_normal((B, H, T, d)) * d ** -0.5, BF)
    k = jnp.asarray(rng.standard_normal((B, H, S, d)), BF)
    v = jnp.asarray(rng.standard_normal((B, H, S, d)), BF)
    bias = jnp.asarray(np.where(np.arange(S)[None] < np.asarray(lens)[:, None], 0.0, -1e9), BF)
    do = jnp.asarray(rng.standard_normal((B, H, T, d)), BF)
    _, vjp = jax.vjp(lambda *a: jkeybias(*a, True), q, k, v, bias)
    want = vjp(do)

    args = [torch.from_numpy(_f32(a)).bfloat16().requires_grad_() for a in (q, k, v, bias)]
    kb.launches = kb.launches_bf16 = 0
    out = kb.keybias_attention(*args)
    out.backward(torch.from_numpy(_f32(do)).bfloat16())
    assert kb.launches == kb.launches_bf16 == 0  # CPU tensors: the plain version
    for name, a, w in zip(("dq", "dk", "dv", "dkb"), args, want):
        assert a.grad.dtype == torch.bfloat16 and w.dtype == BF, name
        dis = kb.bf16_disagreement(a.grad, torch.from_numpy(_f32(w)))
        assert max(dis["worst"], dis["rms_worst"]) <= 1.0, (name, dis)


# ------------------------------------------------- towers and terms --


def _perturb_norms(module, rng):
    """BatchNorm scales, shifts and running statistics drawn away from the
    identity, so the bfloat16 normalisation is exercised."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (BatchNorm2d, BatchNorm3d)):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.8, 1.2, n)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.05, n)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.05, n)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.8, 1.25, n)))
    return module


@pytest.fixture(scope="module")
def neural():
    """JAX's ``_neural_losses`` and the towers' outputs on the predicted
    video, with the gradient at the predicted vertices, at float32 and at
    bfloat16, and the port's at bfloat16. Renders at 24^2 (the command's
    tiny size); two clips of 4 frames, doubled by the exchange (perm [1,
    0]); expression labels 1 and 8 (8 lies past the classifiers' 8 classes
    and adds 0 to the video-emotion cross-entropy, as JAX's one-hot)."""
    rng = np.random.default_rng(0)
    g = torch.Generator().manual_seed(7)
    lip32 = _perturb_norms(random_module(LipReadingNet, CPU, g), rng)
    emo32 = _perturb_norms(random_module(lambda: EmotionRecognitionModule(n_expression=8), CPU,
                                         g), rng)
    lv = lipread_params_from_torch(lip32.state_dict())
    ev = emotion_module_params_from_torch(emo32.state_dict())
    vv = jax.jit(JVemo(**VEMO).init)(jax.random.PRNGKey(7), jnp.zeros((1, 4, 2048)))

    assets = jassets.synthetic_assets(n_shape=8, n_exp=6)
    faces = np.array(assets.faces)
    v0 = np.asarray(assets.v_template)
    gt = (v0[None, None] + rng.standard_normal((2, 4) + v0.shape) * 0.01).astype(np.float32)
    pred = (np.concatenate([gt, gt[::-1]])
            + rng.standard_normal((4, 4) + v0.shape) * 0.01).astype(np.float32)
    expr = np.eye(9, dtype=np.float32)[[1, 8]]
    perm = np.array([1, 0])

    def jax_side(dt):
        lip, emo, vemo = JLip(dtype=dt), JEmo(n_expression=8, dtype=dt), JVemo(**VEMO, dtype=dt)
        jn = JNeural(renderer=JRenderer(faces, image_size=24), lipread=JLipLoss(lip, lv),
                     lipread_weight=1.0, emonet=JEmoNetLoss(emo), emonet_variables=ev,
                     emotion_weight=1.0, video_emotion=JVemoLoss(vemo, vv),
                     video_emotion_weight=0.1)
        trainer = JTrainer(head=None, tx=None, neural=jn)
        towers = {}

        def first_call(name, fn):  # the towers' outputs on the predicted rows
            def wrapped(x):
                out = fn(x)
                towers.setdefault(name, out)
                return out
            return wrapped

        jn.emo_outputs = first_call("emo", jn.emo_outputs)
        jn.lipread.features = first_call("lip", jn.lipread.features)

        def f(p, g):
            towers.clear()
            metrics = {}
            loss = trainer._neural_losses({"vertices": p}, {"gt_vertices": g, "expression": expr},
                                          2, jnp.asarray(perm), metrics)
            emo_out = towers["emo"]
            return loss, (metrics, dict(emo_out, lip=towers["lip"],
                                        vemo=vemo.apply(vv, emo_out["emo_feat_2"])))

        (loss, (metrics, towers)), grad = _compiled(
            lambda p, g: jax.value_and_grad(f, has_aux=True)(p, g), pred, gt,
            exact=dt == BF, options=O0)
        return {"loss": loss, "metrics": metrics, "towers": towers, "grad": grad}

    dt = torch.bfloat16
    lip, emo = LipReadingNet(dtype=dt), EmotionRecognitionModule(n_expression=8, dtype=dt)
    lip.load_state_dict(lip32.state_dict())
    emo.load_state_dict(emo32.state_dict())
    vemo = random_module(lambda: VideoEmotionClassifier(**VEMO, dtype=dt), CPU, g)
    vemo.load_state_dict({k: torch.as_tensor(v) for k, v in video_emotion_state_from_jax(
        jax.tree.map(np.asarray, vv)["params"]).items()})
    tn = NeuralLosses(renderer=FixedViewRenderer(faces, image_size=24, device="cpu"),
                      lipread=LipReadingLoss(lip), lipread_weight=1.0,
                      emonet=EmoNetLoss(emo), emotion_weight=1.0,
                      video_emotion=VideoEmotionLoss(vemo), video_emotion_weight=0.1)
    tp = torch.from_numpy(pred).requires_grad_()
    metrics = {}
    loss = tn.loss(tp, torch.from_numpy(gt), {"expression": torch.from_numpy(expr)}, 2,
                   torch.from_numpy(perm), metrics)
    loss.backward()
    with torch.no_grad():
        video = tn.render_video(tp)
        emo_out = tn.emo_outputs(video)
        towers = dict(emo_out, lip=tn.lipread.features(tn.mouth_crops(video)),
                      vemo=vemo(emo_out["emo_feat_2"]))
    port = {"loss": loss.detach(), "metrics": {k: v.detach() for k, v in metrics.items()},
            "towers": towers, "grad": tp.grad}
    return {"f32": jax_side(jnp.float32), "bf16": jax_side(BF), "port": port}


@pytest.mark.parametrize("tower,keys", [
    ("lip reading", ("lip",)),
    ("ResNet-50", ("emo_feat_2",)),
    ("EmoNet heads", ("expr_classification", "valence", "arousal")),
    ("video emotion", ("vemo",)),
])
def test_towers_bf16_match_jax(neural, tower, keys):
    """Each tower at bfloat16 on the predicted video's frames (the Conv3d
    front end, the BatchNorms, the pools, the encoder): by the rule, its
    outputs in bfloat16."""
    port, jb, jf = (neural[s]["towers"] for s in ("port", "bf16", "f32"))
    for k in keys:
        assert port[k].dtype == torch.bfloat16 and jb[k].dtype == BF, k
    cat = lambda t: np.concatenate([_f32(t[k]).ravel() for k in keys])  # noqa: E731
    assert_closer(tower, cat(port), cat(jb), cat(jf))


def test_neural_terms_bf16_match_jax(neural):
    """The six neural terms and their sum at bfloat16, by the rule, in JAX's
    dtypes (lip reading and emotion in bfloat16, the video-emotion
    cross-entropy promoted to float32 by the one-hot labels)."""
    port, jb, jf = (neural[s] for s in ("port", "bf16", "f32"))
    assert set(port["metrics"]) == set(jb["metrics"]) and len(port["metrics"]) == 6
    names = sorted(port["metrics"])
    for k in names:
        want = jnp.dtype(jb["metrics"][k].dtype).name
        assert str(port["metrics"][k].dtype) == f"torch.{want}", k
    vec = lambda m: np.array([float(m[k]) for k in names + ["loss"]])  # noqa: E731
    assert_closer("neural terms", vec(dict(port["metrics"], loss=port["loss"])),
                  vec(dict(jb["metrics"], loss=jb["loss"])),
                  vec(dict(jf["metrics"], loss=jf["loss"])))


def test_neural_vertex_gradient_bf16_matches_jax(neural):
    """d(neural loss) / d(predicted vertices) through the bfloat16 towers,
    the float32 render and the rasterizer's interpolation: by the rule, and
    not zero."""
    port, jb, jf = (neural[s]["grad"] for s in ("port", "bf16", "f32"))
    assert port.dtype == torch.float32 and float(port.abs().max()) > 0
    assert_closer("vertex gradient", port, jb, jf)


# ------------------------------------------------------------ steps --


@pytest.fixture(scope="module")
def steps():
    """Three AdamW steps of the tiny head on ``emote_case``'s batch: JAX at
    float32 and at bfloat16 (the trainer's own ``loss_fn`` and update, also
    returning the gradients), the port at bfloat16, all from JAX's weights
    at PRNGKey(0)."""
    jcfg = JConfig.tiny()
    batch = _batch(jcfg)
    _, variables = _init(jcfg, batch)
    tx = optax.adamw(LR)
    jb = jax.tree.map(jnp.asarray, batch)

    def jax_side(dt):
        trainer = JTrainer(head=JHead(jcfg, dtype=dt), tx=tx)

        def step(v, opt, rng):
            (_, metrics), grads = jax.value_and_grad(trainer.loss_fn, has_aux=True)(v, jb, rng)
            updates, opt = tx.update(grads, opt, v)
            return optax.apply_updates(v, updates), opt, metrics, grads

        compiled = jax.jit(step).lower(variables, tx.init(variables), jax.random.PRNGKey(0))
        compiled = compiled.compile(
            compiler_options=dict(O0, xla_allow_excess_precision=False) if dt == BF else O0)
        v, opt, ms = variables, tx.init(variables), []
        for i in range(3):
            v, opt, metrics, grads = compiled(v, opt, jax.random.PRNGKey(i))
            ms.append({k: float(x) for k, x in metrics.items()})
            if i == 0:
                first = emote_head_state_from_jax(jax.tree.map(np.asarray, grads))
        return {"metrics": ms, "grads": first,
                "state": emote_head_state_from_jax(jax.tree.map(np.asarray, v))}

    cond_dim = sum(batch[k].shape[-1] for k in ("expression", "intensity", "identity", "shape"))
    tm = random_module(lambda: EmoteTalkingHead(EmoteConfig.tiny(), condition_dim=cond_dim,
                                                dtype=torch.bfloat16),
                       CPU, torch.Generator().manual_seed(0))
    tm.load_state_dict({k: torch.as_tensor(v)
                        for k, v in emote_head_state_from_jax(variables).items()})
    trainer = TalkingHeadTrainer(head=tm, optimizer=adamw(emote_trainables(tm), LR))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ms = []
    for i in range(3):
        ms.append({k: float(x) for k, x in trainer.train_step(tb).items()})
        if i == 0:
            named = dict(tm.named_parameters(), **dict(tm.named_buffers()))
            first = {k: t.grad.clone() for k, t in named.items() if t.grad is not None}
    port = {"metrics": ms, "grads": first, "state": tm.state_dict(),
            "start": emote_head_state_from_jax(jax.tree.map(np.asarray, variables))}
    return {"f32": jax_side(jnp.float32), "bf16": jax_side(BF), "port": port}


def test_bf16_step_gradients_match_jax(steps):
    """The first step's gradient of every weight and BatchNorm statistic
    (from the same weights): each tensor's by the rule (no farther, for
    tensors where both distances vanish), all of them together strictly;
    the key biases, whose exact gradient is 0, are left out."""
    port, jb, jf = (steps[s]["grads"] for s in ("port", "bf16", "f32"))
    names = sorted(k for k in jb if _noise_free(k) and not k.endswith("num_batches_tracked"))
    assert set(port) == set(names) | {k for k in port if not _noise_free(k)}
    for k in names:
        a, b, c = _flat(port, [k]), _flat(jb, [k]), _flat(jf, [k])
        assert _rms(a, b) <= _rms(b, c), (k, _rms(a, b), _rms(b, c))
    assert_closer("gradients", _flat(port, names), _flat(jb, names), _flat(jf, names))


def test_bf16_three_steps_losses_match_jax(steps):
    """Every metric of the three steps (the loss and its four terms), by the
    rule over all fifteen."""
    port, jb, jf = (steps[s]["metrics"] for s in ("port", "bf16", "f32"))
    keys = sorted(jb[0])
    assert all(set(m) == set(keys) for m in port)
    vec = lambda ms: np.array([m[k] for m in ms for k in keys])  # noqa: E731
    assert np.all(np.isfinite(vec(port))) and vec(port)[0] > vec(port)[-5]
    assert_closer("metrics", vec(port), vec(jb), vec(jf))


def test_bf16_three_steps_parameters_match_jax(steps):
    """Every weight and statistic after three steps by the rule; the key
    biases within 2·lr a step of JAX's bfloat16 run; the
    weights stay float32 and moved."""
    port, jb, jf = (steps[s]["state"] for s in ("port", "bf16", "f32"))
    assert set(port) == set(jb) | {k for k in port if k.endswith("num_batches_tracked")}
    assert all(port[k].dtype == torch.float32 for k in port if k.endswith(("weight", "bias")))
    names = sorted(k for k in jb if _noise_free(k) and not k.endswith("num_batches_tracked"))
    assert_closer("parameters", _flat(port, names), _flat(jb, names), _flat(jf, names))
    for k in jb:
        if not _noise_free(k):
            np.testing.assert_allclose(_f32(port[k]), jb[k], atol=2 * LR * 3 + 1e-7, rtol=0)
        elif k.endswith("in_proj_bias"):
            d = jb[k].shape[0] // 3
            np.testing.assert_allclose(_f32(port[k])[d:2 * d], jb[k][d:2 * d],
                                       atol=2 * LR * 3 + 1e-7, rtol=0)
    start = steps["port"]["start"]
    assert max(float(np.abs(_f32(port[k]) - start[k]).max()) for k in names) > 2e-4
