"""Port parity, the FaceFormer family: the positional biases, the decoder
stack, ``FaceFormerCoeff`` and ``FaceFormerVert`` (teacher-forced forward
and the KV-cached ``predict``), ``disentangle_losses`` and
``convert_coeff2verts``, at the tiny configs with weights carried by
infra.jax_params. On the CPU the decoder's K3 takes its plain version."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.core import FlameModel as JFlame
from avi_talking_tpu.core import synthetic_assets as j_synthetic_assets
from avi_talking_tpu.models import faceformer as jff
from avi_talking_tpu.models import faceformer_vert as jffv
from avi_talking_tpu.ops import positional as jpos
from avi_talking_tpu.ops.transformer import TransformerDecoder as JDecoder
from avi_talking_tpu_torch.core.assets import synthetic_assets as t_synthetic_assets
from avi_talking_tpu_torch.core.flame import FlameModel as TFlame
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.infra.jax_params import (
    faceformer_state_from_jax,
    faceformer_vert_state_from_jax,
    transformer_decoder_state_from_jax,
)
from avi_talking_tpu_torch.models import faceformer as tff
from avi_talking_tpu_torch.models import faceformer_vert as tffv
from avi_talking_tpu_torch.ops import positional as tpos
from avi_talking_tpu_torch.ops.kernels import bias_attention as kba
from avi_talking_tpu_torch.ops.transformer import TransformerDecoder as TDecoder
from _torch_threads import one_torch_thread  # noqa: F401


def _load(model, state):
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model


def _randomize(params, seed, scale=0.05):
    """Every leaf random (as the JAX FaceFormer tests do), so the zero-init
    head and embeddings carry weight; ``params`` may be the shapes that
    ``jax.eval_shape`` of an init gives (its values are never read)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
                        params)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("n_heads", [1, 2, 3, 4, 5, 6, 8, 12])
def test_alibi_slopes_bit_equal(n_heads):
    got, ref = tpos.alibi_slopes(n_heads), jpos.alibi_slopes(n_heads)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("H,T,period,causal", [(4, 25, 25, True), (4, 60, 25, True),
                                               (3, 17, 5, False), (8, 31, 30, True)])
def test_faceformer_bias_bit_equal(H, T, period, causal):
    got = tpos.faceformer_bias(H, T, period, causal=causal)
    ref = np.asarray(jpos.faceformer_bias(H, T, period, causal=causal))
    assert got.shape == ref.shape == (H, T, T) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("T,S,k", [(25, 25, 1), (10, 20, 2), (7, 5, 1)])
def test_enc_dec_alignment_bias_bit_equal(T, S, k):
    got = tpos.enc_dec_alignment_bias(T, S, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpos.enc_dec_alignment_bias(T, S, k)))


@pytest.mark.parametrize("layers,S", [(1, 12), (2, 9)])
def test_transformer_decoder_matches_jax(layers, S):
    """Post-LN decoder, self-attention with the FaceFormer bias and
    cross-attention with a (T, S) bias, K3's plain version in both: < 1e-5."""
    B, T, D, H = 2, 12, 32, 4
    rng = np.random.default_rng(layers)
    tgt = rng.standard_normal((B, T, D)).astype(np.float32)
    mem = rng.standard_normal((B, S, D)).astype(np.float32)
    tb = np.asarray(jpos.faceformer_bias(H, T, 5))
    mb = np.where(rng.random((T, S)) < 0.3, -1e9, 0.0).astype(np.float32)
    jm = JDecoder(layers, D, H, 2 * D)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), tgt, mem, tb, mb)
    params = {"params": _randomize(params["params"], seed=3, scale=0.3)}
    ref = np.asarray(jm.apply(params, tgt, mem, tb, mb))
    tm = _load(random_module(lambda: TDecoder(layers, D, H, 2 * D), torch.device("cpu"),
                             torch.Generator().manual_seed(0)),
               transformer_decoder_state_from_jax(params["params"]))
    kba.launches = 0
    with torch.no_grad():
        got = tm(*_t(tgt, mem, tb, mb)).numpy()
    assert kba.launches == 0
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


# ---- FaceFormerCoeff ------------------------------------------------------

def _coeff_case(merge: bool, seed: int):
    cfg = jff.FaceFormerConfig.tiny()
    if not merge:
        cfg = dataclasses.replace(cfg, with_condition_merge=False)
    B, T = 2, 12
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((B, T * 640)).astype(np.float32)
    coeffs = rng.standard_normal((B, T, cfg.vertice_dim)).astype(np.float32)
    cond = (rng.standard_normal((B, T, cfg.eye_dim)).astype(np.float32),
            rng.standard_normal((B, T, cfg.emo_dim)).astype(np.float32),
            rng.standard_normal((B, 1, cfg.vertice_dim)).astype(np.float32)) if merge else ()
    jm = jff.FaceFormerCoeff(cfg)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), audio, coeffs, *cond)
    params = {"params": _randomize(params["params"], seed=7)}
    tcfg = tff.FaceFormerConfig.tiny()
    if not merge:
        tcfg = dataclasses.replace(tcfg, with_condition_merge=False)
    tm = _load(tff.FaceFormerCoeff.random_init(tcfg, device="cpu"),
               faceformer_state_from_jax(params["params"]))
    return jm, params, tm, audio, coeffs, cond


@pytest.fixture(scope="module", params=[True, False], ids=["merge", "no_merge"])
def coeff_case(request):
    return _coeff_case(request.param, seed=0)


def test_faceformer_coeff_forward_matches_jax(coeff_case):
    jm, params, tm, audio, coeffs, cond = coeff_case
    ref = np.asarray(jax.jit(jm.apply)(params, audio, coeffs, *cond))
    with torch.no_grad():
        got = tm(*_t(audio, coeffs, *cond)).numpy()
    assert got.shape == coeffs.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_faceformer_coeff_predict_matches_jax(coeff_case):
    jm, params, tm, audio, coeffs, cond = coeff_case
    T = coeffs.shape[1]
    ref = np.asarray(jax.jit(lambda p, a, *c: jm.apply(p, a, T, *c, method="predict"))(
        params, audio, *cond))
    got = tm.predict(torch.from_numpy(audio), T, *_t(*cond)).numpy()
    assert got.shape == coeffs.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_faceformer_coeff_ar_consistent_with_teacher_forcing(coeff_case):
    """With the start tokens aligned (zero obj_embedding and zero
    vertice_map bias), the teacher-forced pass on predict's own outputs
    gives them back: the port's KV cache, per-step ALiBi and single-key
    cross-attention against its K3 decoder."""
    tm, audio, coeffs, cond = copy.deepcopy(coeff_case[2]), *coeff_case[3:]
    with torch.no_grad():
        tm.obj_embedding.zero_()
        tm.vertice_map.bias.zero_()
        ar = tm.predict(torch.from_numpy(audio), coeffs.shape[1], *_t(*cond))
        tf = tm(torch.from_numpy(audio), ar, *_t(*cond))
    np.testing.assert_allclose(tf.numpy(), ar.numpy(), rtol=2e-4, atol=2e-5)


def test_faceformer_coeff_random_init_emits_zeros():
    cfg = tff.FaceFormerConfig.tiny()
    m = tff.FaceFormerCoeff.random_init(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(1)
    audio, coeffs = _t(rng.standard_normal((1, 8 * 640)).astype(np.float32),
                       rng.standard_normal((1, 8, cfg.vertice_dim)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(m(audio, coeffs), torch.zeros_like(coeffs))
    again = tff.FaceFormerCoeff.random_init(cfg, seed=3, device="cpu")
    for (name, a), b in zip(m.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name


# ---- FaceFormerVert -------------------------------------------------------

@pytest.fixture(scope="module")
def vert_case():
    cfg = jffv.FaceFormerVertConfig.tiny()
    rng = np.random.default_rng(0)
    template = (rng.standard_normal(cfg.vertice_dim) * 0.1).astype(np.float32)
    B, T = 3, 10
    audio = rng.standard_normal((B, T * 640)).astype(np.float32)
    verts = rng.standard_normal((B, T, cfg.vertice_dim)).astype(np.float32)
    emo = rng.standard_normal((B, T, cfg.emo_dim)).astype(np.float32)
    jm = jffv.FaceFormerVert(cfg, template=jnp.asarray(template))
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), audio, verts, emo)
    params = {"params": _randomize(params["params"], seed=3)}
    tm = _load(tffv.FaceFormerVert.random_init(tffv.FaceFormerVertConfig.tiny(),
                                               template=torch.from_numpy(template), device="cpu"),
               faceformer_vert_state_from_jax(params["params"]))
    return jm, params, tm, audio, verts, emo


def test_faceformer_vert_forward_and_predict_match_jax(vert_case):
    jm, params, tm, audio, verts, emo = vert_case
    T = verts.shape[1]
    ref_tf = np.asarray(jax.jit(jm.apply)(params, audio, verts, emo))
    ref_ar = np.asarray(jax.jit(lambda p, a, e: jm.apply(p, a, T, e, method="predict"))(
        params, audio, emo))
    with torch.no_grad():
        got_tf = tm(*_t(audio, verts, emo)).numpy()
    got_ar = tm.predict(torch.from_numpy(audio), T, torch.from_numpy(emo)).numpy()
    np.testing.assert_allclose(got_tf, ref_tf, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_ar, ref_ar, atol=1e-4, rtol=0)


def test_disentangle_losses_match_jax(vert_case):
    """JAX's two permutations, passed to the port: each loss < 1e-5."""
    jm, params, tm, audio, verts, emo = vert_case
    V = verts.shape[-1] // 3
    sel = jffv.FlameRegionSelector(frontal=np.ones(V, bool), mouth=np.arange(V) < V // 2,
                                   eye=np.arange(V) >= V // 2)
    key = jax.random.PRNGKey(4)
    ref = jax.jit(lambda p, a, v, e, k: jffv.disentangle_losses(jm, p, a, v, e, sel, k))(
        params, jnp.asarray(audio), jnp.asarray(verts), jnp.asarray(emo), key)
    r1, r2 = jax.random.split(key)
    perms = (np.asarray(jax.random.permutation(r1, emo.shape[0])),
             np.asarray(jax.random.permutation(r2, audio.shape[0])))
    tsel = tffv.FlameRegionSelector(frontal=sel.frontal, mouth=sel.mouth, eye=sel.eye)
    with torch.no_grad():
        got = tffv.disentangle_losses(tm, *_t(audio, verts, emo), tsel,
                                      perms=tuple(_t(*perms)))
    assert set(got) == set(ref) == {"verts", "verts_eye_area", "verts_mouth_area"}
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), atol=1e-5, rtol=1e-5, err_msg=k)


def test_region_selector_matches_jax():
    kw = dict(num_vertices=400, n_shape=8, n_exp=6, num_faces=100, seed=2)
    ja, ta = j_synthetic_assets(**kw), t_synthetic_assets(**kw)
    rng = np.random.default_rng(5)
    v = rng.uniform(-0.1, 0.1, (400, 3)).astype(np.float32)
    v[:, 1] += 1.48
    for jsel, tsel in ((jffv.FlameRegionSelector.from_assets(ja),
                        tffv.FlameRegionSelector.from_assets(ta)),
                       (jffv.FlameRegionSelector.from_template(v),
                        tffv.FlameRegionSelector.from_template(torch.from_numpy(v)))):
        for name in ("frontal", "mouth", "eye"):
            np.testing.assert_array_equal(tsel.unfold(name), jsel.unfold(name))
    assert jsel.eye.any() and jsel.mouth.any()


def test_convert_coeff2verts_matches_jax():
    kw = dict(n_shape=8, n_exp=6, seed=1)
    jflame = JFlame(j_synthetic_assets(**kw), n_shape=8, n_exp=6)
    tflame = TFlame(t_synthetic_assets(**kw), n_shape=8, n_exp=6)
    rng = np.random.default_rng(2)
    coeff = rng.standard_normal((4, 9)).astype(np.float32)
    mean = (rng.standard_normal(12) * 0.1).astype(np.float32)
    std = (1.0 + rng.random(12)).astype(np.float32)
    ref = np.asarray(jffv.convert_coeff2verts(jflame, coeff, mean, std))
    got = tffv.convert_coeff2verts(tflame, *_t(coeff, mean, std)).numpy()
    assert got.shape == ref.shape == (4, jflame.assets.v_template.shape[0] * 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
