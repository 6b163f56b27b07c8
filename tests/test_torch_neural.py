"""Port parity of the neural-loss modules: the perception towers
(models/resnet.py, emoca.py, lipread.py, video_emotion.py) with weights
carried by ``infra.jax_params``, their losses, the ``FixedViewRenderer``
and the gradient route of the kernel rasterizer (visibility from K2's plain
version on the CPU), against the JAX package on the CPU.

Tolerances: the towers and losses 1e-4 (atol and rtol); renders at JAX's
image tolerance (rtol 1e-5, atol 1e-6) with masks equal; the rasterizer's
gradients at the JAX suite's Pallas-against-XLA tolerance (rtol 1e-3, atol
1e-4, tests/test_pallas_attention.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.core.assets import synthetic_assets as j_assets
from avi_talking_tpu.models import emoca as jemoca
from avi_talking_tpu.models import lipread as jlip
from avi_talking_tpu.models import video_emotion as jvemo
from avi_talking_tpu.viz import rasterizer as jr
from avi_talking_tpu.viz import visualizer as jviz
from avi_talking_tpu_torch.infra import jax_params
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.models import emoca as temoca
from avi_talking_tpu_torch.models import lipread as tlip
from avi_talking_tpu_torch.models import video_emotion as tvemo
from avi_talking_tpu_torch.viz import rasterizer as tr
from avi_talking_tpu_torch.viz import visualizer as tviz
from test_torch_rasterizer import head_proxy_mesh, random_mesh
from _torch_threads import one_torch_thread  # noqa: F401


TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")


def _perturb_stats(variables, seed):
    """Running statistics away from flax's init (mean 0, var 1), so that the
    carried ``batch_stats`` are read."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "mean":
            return jnp.asarray(rng.normal(0.0, 0.1, x.shape).astype(np.float32))
        return jnp.asarray(rng.uniform(0.5, 1.5, x.shape).astype(np.float32))

    return {**variables,
            "batch_stats": jax.tree_util.tree_map_with_path(leaf, variables["batch_stats"])}


def _port(factory, state):
    module = random_module(factory, CPU, torch.Generator().manual_seed(0))
    module.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return module


def _np(x):
    return jax.tree.map(np.asarray, x)


def test_emotion_module_matches_jax():
    """EmotionRecognitionModule (ResNet-50 and the linear head) on (2, 24,
    24, 3) images: every output."""
    images = np.random.default_rng(0).random((2, 24, 24, 3)).astype(np.float32)
    jm = jemoca.EmotionRecognitionModule(n_expression=8)
    variables = _perturb_stats(
        jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, 24, 24, 3))), 2)
    ref = _np(jax.jit(jm.apply)(variables, jnp.asarray(images)))
    tm = _port(lambda: temoca.EmotionRecognitionModule(n_expression=8),
               jax_params.emotion_module_state_from_jax(_np(variables)))
    with torch.no_grad():
        got = tm(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k], err_msg=k, **TOL)
    assert float(np.abs(ref["emo_feat_2"]).max()) > 1e-3
    # the loss over two image sets (each through the tower)
    gt = images[::-1].copy()
    jl, _ = jemoca.EmoNetLoss(jm)(variables, jnp.asarray(images), jnp.asarray(gt))
    tl, _ = temoca.EmoNetLoss(tm)(torch.from_numpy(images).permute(0, 3, 1, 2),
                                  torch.from_numpy(gt).permute(0, 3, 1, 2))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)


def test_lipread_net_matches_jax():
    """LipReadingNet (Conv3d front end, ResNet-18 trunk with swish) on (1,
    2, 24, 24, 1) crops."""
    crops = np.random.default_rng(3).standard_normal((1, 2, 24, 24, 1)).astype(np.float32)
    jm = jlip.LipReadingNet()
    variables = _perturb_stats(
        jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.zeros((1, 2, 24, 24, 1))), 5)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(crops)))
    tm = _port(tlip.LipReadingNet, jax_params.lipread_state_from_jax(_np(variables)))
    with torch.no_grad():
        got = tm(torch.from_numpy(crops)).numpy()
    assert got.shape == ref.shape == (1, 2, 512)
    np.testing.assert_allclose(got, ref, **TOL)
    # the cosine loss over two crop sequences (each through the net)
    gt = crops[:, ::-1].copy()
    jl = jlip.LipReadingLoss(jm, variables)(jnp.asarray(crops), jnp.asarray(gt))
    tl = tlip.LipReadingLoss(tm)(torch.from_numpy(crops), torch.from_numpy(gt))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)


def test_video_emotion_classifier_matches_jax():
    """VideoEmotionClassifier, feature_dim 16, one layer, 2 heads, on (2,
    5, 2048) features."""
    feats = np.random.default_rng(6).standard_normal((2, 5, 2048)).astype(np.float32)
    kw = dict(n_classes=8, feature_dim=16, num_layers=1, nhead=2, input_dim=2048)
    jm = jvemo.VideoEmotionClassifier(**kw)
    params = jm.init(jax.random.PRNGKey(7), jnp.zeros((1, 4, 2048)))
    ref = np.asarray(jm.apply(params, jnp.asarray(feats)))
    tm = _port(lambda: tvemo.VideoEmotionClassifier(**kw),
               jax_params.video_emotion_state_from_jax(_np(params)["params"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("labels", [[8, 3], [0, 7], [8, 8]])
def test_video_emotion_loss_matches_jax(labels):
    """Cross-entropy to labels, where a label of 8 (the command's ninth
    expression class, past the classifier's 8) is a row of zeros that adds
    0 and still counts in the mean; and to ground-truth logits."""
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((2, 3, 32)).astype(np.float32)
    gt_logits = rng.standard_normal((2, 8)).astype(np.float32)
    kw = dict(n_classes=8, feature_dim=16, num_layers=1, nhead=2, input_dim=32)
    jm = jvemo.VideoEmotionClassifier(**kw)
    params = jm.init(jax.random.PRNGKey(9), jnp.zeros((1, 3, 32)))
    jloss = jvemo.VideoEmotionLoss(jm, params)
    tm = _port(lambda: tvemo.VideoEmotionClassifier(**kw),
               jax_params.video_emotion_state_from_jax(_np(params)["params"]))
    tloss = tvemo.VideoEmotionLoss(tm)
    lab = np.asarray(labels)
    with torch.no_grad():
        got = float(tloss(torch.from_numpy(feats), gt_label=torch.from_numpy(lab)))
        got_logits = float(tloss(torch.from_numpy(feats), gt_logits=torch.from_numpy(gt_logits)))
        logp = torch.log_softmax(tm(torch.from_numpy(feats)), -1)
    np.testing.assert_allclose(got, float(jloss(jnp.asarray(feats), gt_label=jnp.asarray(lab))),
                               **TOL)
    np.testing.assert_allclose(got_logits, float(jloss(jnp.asarray(feats),
                                                       gt_logits=jnp.asarray(gt_logits))), **TOL)
    want = -sum(float(logp[i, c]) for i, c in enumerate(labels) if c < 8) / len(labels)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("metric", ["cosine", "l1", "l2"])
@pytest.mark.parametrize("masked", [False, True])
def test_lipread_loss_matches_jax(metric, masked):
    """``from_features`` on (2, 4, 512) features, with a zero feature row
    (the cosine's per-side 1e-8 clamp) and an optional frame mask."""
    rng = np.random.default_rng(10)
    fp, fg = (rng.standard_normal((2, 4, 512)).astype(np.float32) for _ in range(2))
    fp[1, 2] = 0.0
    mask = np.asarray([[1, 1, 0, 1], [1, 0, 1, 1]], np.float32) if masked else None
    jl = jlip.LipReadingLoss(jlip.LipReadingNet(), {}, metric=metric)
    tl = tlip.LipReadingLoss(tlip.LipReadingNet(), metric=metric)
    ref = float(jl.from_features(jnp.asarray(fp), jnp.asarray(fg),
                                 None if mask is None else jnp.asarray(mask)))
    got = float(tl.from_features(torch.from_numpy(fp), torch.from_numpy(fg),
                                 None if mask is None else torch.from_numpy(mask)))
    np.testing.assert_allclose(got, ref, **TOL)


def test_emonet_loss_from_outputs_matches_jax():
    """Feature MSE plus weighted valence and arousal terms."""
    rng = np.random.default_rng(11)
    p, g = ({k: rng.standard_normal(s).astype(np.float32)
             for k, s in (("emo_feat_2", (2, 3, 2048)), ("valence", (2, 3)), ("arousal", (2, 3)))}
            for _ in range(2))
    kw = dict(feat_weight=1.0, valence_weight=0.5, arousal_weight=0.25)
    jl, jm = jemoca.EmoNetLoss(jemoca.EmotionRecognitionModule(), **kw).from_outputs(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g))
    tl, tm = temoca.EmoNetLoss(None, **kw).from_outputs(
        {k: torch.from_numpy(v) for k, v in p.items()},
        {k: torch.from_numpy(v) for k, v in g.items()})
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("shape,crop", [((2, 3, 90, 112), 88), ((2, 3, 90, 112, 1), 88),
                                        ((4, 10, 12), 88), ((5, 30, 41), 24)])
def test_mouth_transform_matches_jax(shape, crop):
    images = np.random.default_rng(12).random(shape).astype(np.float32)
    got = tlip.mouth_transform(torch.from_numpy(images), crop).numpy()
    ref = np.asarray(jlip.mouth_transform(jnp.asarray(images), crop))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", [24, 224])
def test_crop_mouth_matches_jax(size):
    images = np.random.default_rng(13).random((2, 3, size, size, 3)).astype(np.float32)
    faces = np.zeros((1, 3), np.int32)
    got = tviz.FixedViewRenderer(faces, size, device="cpu").crop_mouth(torch.from_numpy(images))
    ref = jviz.FixedViewRenderer(faces, size).crop_mouth(images)
    np.testing.assert_array_equal(got.numpy(), ref)


def _tiny_flame_frames(T=3):
    """The tiny config's synthetic FLAME (64 faces: the dense route),
    jittered per frame."""
    assets = j_assets(n_shape=8, n_exp=6)
    v = np.asarray(assets.v_template)
    rng = np.random.default_rng(14)
    frames = v[None] + rng.standard_normal((T,) + v.shape).astype(np.float32) * 0.01
    return frames.astype(np.float32), np.array(assets.faces)


def _head_frames(T=2):
    """The closed head mesh (4224 faces: the binned route) in model space,
    framed by the renderer's camera."""
    hv, faces = head_proxy_mesh()
    frames = [np.stack([hv[:, 0] / 8, -hv[:, 1] / 8 + 0.01, -hv[:, 2] / 8], -1) * (1 - 0.04 * k)
              for k in range(T)]
    return np.asarray(frames, np.float32), faces


@pytest.mark.parametrize("frames,size", [(_tiny_flame_frames, 24), (_head_frames, 224)])
def test_fixed_view_renderer_matches_jax(frames, size):
    """``render_torch`` against ``render_jax``: at 24^2 on the tiny mesh
    (dense route) and at 224^2 on the head mesh (binned route, tile 56);
    masks equal, images at JAX's tolerance; ``render`` stacks the views."""
    verts, faces = frames()
    jrend = jviz.FixedViewRenderer(faces, image_size=size)
    trend = tviz.FixedViewRenderer(faces, image_size=size, device="cpu")
    ref = np.asarray(jrend.render_jax(jnp.asarray(verts)))
    got = trend.render_torch(torch.from_numpy(verts)).numpy()
    ndc_t = trend.project(torch.from_numpy(verts))
    cam = jnp.broadcast_to(jrend.cams[:1], (verts.shape[0], 3))
    proj = jviz.batch_orth_proj(jnp.asarray(verts), cam)
    ndc_j = jnp.stack([proj[..., 0], -proj[..., 1], -proj[..., 2]], axis=-1)
    np.testing.assert_array_equal(ndc_t.numpy(), np.asarray(ndc_j))
    attrs = np.zeros(verts.shape, np.float32)
    _, m_t = tr.rasterize_auto(ndc_t, trend.faces, torch.from_numpy(attrs), size, size)
    _, m_j = jr.rasterize_auto(ndc_j, jnp.asarray(faces), jnp.asarray(attrs), size, size)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert m_t.float().mean() > 0.05
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    stacked = trend.render(verts)
    assert stacked.shape == (1,) + got.shape
    np.testing.assert_array_equal(stacked[0], got)


@pytest.mark.parametrize("per_corner", [False, True])
@pytest.mark.parametrize("B", [1, 2])
def test_kernel_route_gradients_match_jax(per_corner, B):
    """The gradient of sum(img^2) through ``rasterize_binned_kernel`` (the
    visibility from K2's plain version, a stop-gradient decision; autograd
    through the packed gather) against ``jax.grad`` of
    ``rasterize_binned_pallas`` (its Pallas kernel in interpret mode, its
    hand-composed ``_interp_bwd``), in vertices and in per-vertex or
    per-corner attributes, frame by frame; the vertex gradients are not
    zero."""
    V, F, H = 80, 60, 32
    verts, faces, attrs = random_mesh(7, V, F, B=B)
    if per_corner:
        attrs = np.random.default_rng(15).standard_normal((B, F, 3, 3)).astype(np.float32)

    def loss_j(v, a):
        img, _ = jr.rasterize_binned_pallas(v, jnp.asarray(faces), a, H, H, tile=16, cap=32,
                                            chunk=16, interpret=True, per_corner=per_corner)
        return (img ** 2).sum()

    grad_j = jax.jit(jax.grad(loss_j, argnums=(0, 1)))
    ref = [grad_j(jnp.asarray(verts[b]), jnp.asarray(attrs[b])) for b in range(B)]
    tv = torch.from_numpy(verts).requires_grad_()
    ta = torch.from_numpy(attrs).requires_grad_()
    img, mask = tr.rasterize_binned_kernel(tv, torch.from_numpy(faces), ta, H, H, tile=16,
                                           cap=32, chunk=16, per_corner=per_corner)
    (img ** 2).sum().backward()
    for b in range(B):
        np.testing.assert_allclose(tv.grad[b].numpy(), np.asarray(ref[b][0]), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(ta.grad[b].numpy(), np.asarray(ref[b][1]), rtol=1e-3,
                                   atol=1e-4)
        assert float(tv.grad[b].abs().sum()) > 0
    assert bool(mask.any())
