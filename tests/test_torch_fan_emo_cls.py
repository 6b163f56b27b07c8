"""Port parity, the FAN tower and the rendered emotion loss: ``FanEncoder``'s
four outputs and ``backbone_feature`` at 64^2 and at 112^2 (whose hourglass
floors 7 -> 3 -> 1 and upsamples 3 -> 7), within 1e-4 of the largest value;
a synthetic state dict under the reference torch names through the port's
``load_state_dict(strict=True)`` and JAX's ``fan_encoder_params_from_torch``;
``EmoClsHead``; ``EmoClsLoss``'s value and its gradient in the vertices
against ``jax.grad`` (``-1`` labels masked, an all-invalid batch) and its
resize branch, shrinking and growing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.core import synthetic_assets as j_synthetic_assets
from avi_talking_tpu.models.fan_encoder import FanEncoder as JFan
from avi_talking_tpu.models.fan_encoder import fan_encoder_params_from_torch
from avi_talking_tpu.train import emo_cls as jemo
from avi_talking_tpu_torch.core.assets import synthetic_assets as t_synthetic_assets
from avi_talking_tpu_torch.infra.jax_params import (
    emo_cls_head_state_from_jax,
    fan_encoder_state_from_jax,
)
from avi_talking_tpu_torch.models.fan_encoder import FanEncoder
from avi_talking_tpu_torch.train import emo_cls as temo


def _rel(got, ref) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


def _perturbed(variables, seed):
    """Every leaf moved a little, and BatchNorm statistics away from 0 / 1,
    so that no normalisation is an identity."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.1).astype(np.float32),
        variables)
    out["batch_stats"] = jax.tree.map(lambda a: (np.abs(a) + 0.5).astype(np.float32),
                                      out["batch_stats"])
    return out


def _torch_fan(size, variables):
    m = FanEncoder(size).eval()
    m.load_state_dict({k: torch.as_tensor(v)
                       for k, v in fan_encoder_state_from_jax(variables).items()}, strict=True)
    return m


@pytest.fixture(scope="module", params=[64, 112])
def fan_case(request):
    size = request.param
    jf = JFan()
    variables = _perturbed(jf.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))), 1)
    x = np.random.default_rng(2).standard_normal((2, size, size, 3)).astype(np.float32)
    outs, feat = jax.jit(lambda v, x: (jf.apply(v, x), jf.apply(
        v, x, method=JFan.backbone_feature)))(variables, x)
    return size, variables, x, [np.asarray(o) for o in outs] + [np.asarray(feat)]


def test_fan_encoder_matches_jax(fan_case):
    size, variables, x, ref = fan_case
    m = _torch_fan(size, variables)
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape) for g in got] == [(2, 6), (2, 6), (2, 30), (2, 512)]
    for name, g, r in zip(("headpose", "eye", "emo", "mouth"), got, ref[:4]):
        assert _rel(g, r) < 1e-4, name


def test_backbone_feature_matches_jax(fan_case):
    size, variables, x, ref = fan_case
    ref = ref[4]
    with torch.no_grad():
        got = _torch_fan(size, variables).backbone_feature(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 512) and _rel(got, ref) < 1e-4


def test_reference_state_dict_loads_in_both():
    """A state dict under the reference's names (random values, BatchNorm
    statistics included) loads strictly in the port and through JAX's
    importer, and the two give the same outputs."""
    g = torch.Generator().manual_seed(3)
    sd = {}
    for k, v in FanEncoder(64).state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.long)
        elif k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
    m = FanEncoder(64).eval()
    m.load_state_dict(sd, strict=True)
    jvars = fan_encoder_params_from_torch(sd)
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = JFan().apply(jvars, x)
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    for gt, r in zip(got, ref):
        assert _rel(gt, r) < 1e-4
    # and JAX's tree carries back to the very same state dict
    back = fan_encoder_state_from_jax(jvars)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k].numpy(), err_msg=k)


def test_fan_rejects_another_size():
    with pytest.raises(ValueError, match="built for 64"):
        FanEncoder(64)(torch.zeros(1, 3, 112, 112))


def _head_case():
    head = jemo.EmoClsHead()
    hv = _perturbed(head.init(jax.random.PRNGKey(6), jnp.zeros((1, 512))), 7)
    t = temo.EmoClsHead()
    t.load_state_dict({k: torch.as_tensor(v) for k, v in emo_cls_head_state_from_jax(hv).items()})
    return head, hv, t.eval()


def test_emo_cls_head_matches_jax():
    head, hv, t = _head_case()
    feat = np.random.default_rng(8).standard_normal((5, 512)).astype(np.float32)
    ref = head.apply(hv, feat)
    with torch.no_grad():
        got = t(torch.from_numpy(feat))
    assert got.shape == (5, 8) and _rel(got, ref) < 1e-5
    assert temo.EMO2IDX == jemo.EMO2IDX


@pytest.fixture(scope="module")
def emo_case():
    """The tiny command's towers at 64^2 (FAN perturbed from a random init,
    the head too), the tiny synthetic FLAME, 2 clips of 8 frames."""
    jfan = JFan()
    fan_vars = _perturbed(jfan.init(jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 3))), 9)
    head, hv, thead = _head_case()
    faces = np.array(j_synthetic_assets(n_shape=8, n_exp=6).faces)
    np.testing.assert_array_equal(t_synthetic_assets(n_shape=8, n_exp=6).faces.numpy(), faces)
    verts = (np.random.default_rng(3).standard_normal((2, 8, 128 * 3)) * 0.1).astype(np.float32)

    def jloss(render_size=64):
        return jemo.EmoClsLoss(faces=jnp.asarray(faces), fan=jfan, fan_vars=fan_vars, head=head,
                               head_vars=hv, render_size=render_size, fan_size=64, stride=4)

    def tloss(render_size=64):
        return temo.EmoClsLoss(faces=torch.from_numpy(faces), fan=_torch_fan(64, fan_vars),
                               head=thead, render_size=render_size, fan_size=64, stride=4)

    grad = jax.jit(jax.value_and_grad(lambda v, lab: jloss()(v, lab)))
    return jloss, tloss, verts, grad


@pytest.mark.parametrize("labels", [[5, 1], [5, -1], [-1, -1]])
def test_emo_cls_loss_and_vertex_gradient_match_jax(emo_case, labels):
    _, tloss, verts, grad = emo_case
    lab = np.asarray(labels, np.int32)
    ref, ref_g = grad(jnp.asarray(verts), jnp.asarray(lab))
    v = torch.from_numpy(verts).requires_grad_()
    got = tloss()(v, torch.from_numpy(lab))
    got.backward()
    got = got.detach()
    if labels == [-1, -1]:
        assert float(got) == float(ref) == 0.0
        assert float(v.grad.abs().max()) == 0.0
        return
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=1e-6)
    assert float(np.abs(np.asarray(ref_g)).max()) > 0
    assert _rel(v.grad, ref_g) < 1e-4


@pytest.mark.parametrize("render_size", [96, 48])  # shrink (antialiased) and grow to 64
def test_emo_cls_resize_matches_jax(emo_case, render_size):
    jloss, tloss, verts, _ = emo_case
    lab = np.asarray([5, 1], np.int32)
    ref = jloss(render_size)(jnp.asarray(verts), jnp.asarray(lab))
    t = tloss(render_size)
    got = t(torch.from_numpy(verts), torch.from_numpy(lab))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=1e-6)
    # the resized images themselves
    j = jloss(render_size)
    from avi_talking_tpu.core.projection import batch_orth_proj
    from avi_talking_tpu.viz.rasterizer import render_normal_maps

    v = jnp.asarray(verts)[:, ::4].reshape(4, -1, 3)
    proj = batch_orth_proj(v, jnp.broadcast_to(jnp.asarray([[8.0, 0.0, -0.01]]), (4, 3)))
    ndc = jnp.stack([proj[..., 0], -proj[..., 1], -proj[..., 2]], axis=-1)
    imgs = render_normal_maps(ndc, j.faces, render_size, render_size)
    ref_imgs = jax.image.resize(imgs, (4, 64, 64, 3), method="bilinear")
    with torch.no_grad():
        got_imgs = t.images(torch.from_numpy(verts)).permute(0, 2, 3, 1)
    assert float(np.abs(got_imgs.numpy() - np.asarray(ref_imgs)).max()) < 1e-5
