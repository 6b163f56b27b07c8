"""Port parity, the FaceFormer family at bfloat16 compute.

JAX builds ``FaceFormerCoeff(cfg, dtype=jnp.bfloat16)`` and
``FaceFormerVert(cfg, dtype=jnp.bfloat16)`` over float32 parameters; the
port's ``random_init(..., dtype=torch.bfloat16)`` does the same, with the
decoder's attention on K3's plain version (the CPU route of the bfloat16
kernel) beside float32 biases. Each case runs the same carried weights and
inputs through JAX at float32 and at bfloat16 (compiled with XLA's excess
precision off, ``exact_jit``, once per module) and through the port at
bfloat16, and holds ``test_torch_bf16.assert_closer``'s rule: the port's
bfloat16 result is closer (rms) to JAX's bfloat16 result than JAX's
bfloat16 result is to its float32 one. ``ar_decode`` is held alone too: it
is where JAX rounds differently from the teacher-forced layers (its
LayerNorm's statistics at bfloat16). The tiny configs' decoder heads are 8
wide, below both kernels' steps: on the card the wrapper pads them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.models import ar_decode as jar
from avi_talking_tpu.models import faceformer as jff
from avi_talking_tpu.models import faceformer_vert as jffv
from avi_talking_tpu.ops import positional as jpos
from avi_talking_tpu_torch.infra.jax_params import (
    faceformer_state_from_jax,
    faceformer_vert_state_from_jax,
)
from avi_talking_tpu_torch.models import ar_decode as tar
from avi_talking_tpu_torch.models import faceformer as tff
from avi_talking_tpu_torch.models import faceformer_vert as tffv
from avi_talking_tpu_torch.ops import positional as tpos
from avi_talking_tpu_torch.ops.kernels import bias_attention as kba
from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_bf16 import assert_closer, exact_jit

BF = jnp.bfloat16


def _random_params(module, seed, *args):
    """Every leaf random (scale 0.3), from the shapes of ``module.init``
    (traced, not run), so the zero-init heads carry weight."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32), shapes)


def _both(make, method_args):
    """One function that runs the JAX module at float32 and at bfloat16 on
    the same parameters: the teacher-forced forward and ``predict``."""
    f32, b16 = make(jnp.float32), make(BF)

    def run(params, *inputs):
        tf_args, ar_args = method_args(*inputs)
        return [(m.apply(params, *tf_args), m.apply(params, *ar_args, method="predict"))
                for m in (f32, b16)]
    return run


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _no_launch():
    kb.launches = kb.launches_bf16 = kba.launches = kba.launches_bf16 = 0


# ---- FaceFormerCoeff ------------------------------------------------------

@pytest.fixture(scope="module")
def coeff():
    cfg = jff.FaceFormerConfig.tiny()
    assert cfg.with_condition_merge
    B, T = 2, 12
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((B, T * 640)).astype(np.float32)
    coeffs = rng.standard_normal((B, T, cfg.vertice_dim)).astype(np.float32)
    cond = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, cfg.eye_dim), (B, T, cfg.emo_dim), (B, 1, cfg.vertice_dim))]
    params = _random_params(jff.FaceFormerCoeff(cfg), 7, audio, coeffs, *cond)
    run = _both(lambda dt: jff.FaceFormerCoeff(cfg, dtype=dt),
                lambda a, c, *cond: ((a, c, *cond), (a, T, *cond)))
    (tf32, ar32), (tf16, ar16) = exact_jit(run, params, audio, coeffs, *cond)
    tm = tff.FaceFormerCoeff.random_init(tff.FaceFormerConfig.tiny(), device="cpu",
                                         dtype=torch.bfloat16)
    tm.load_state_dict({k: torch.as_tensor(v)
                        for k, v in faceformer_state_from_jax(params["params"]).items()})
    return {"model": tm, "params": params, "inputs": (audio, coeffs, *cond),
            "tf": (tf16, tf32), "ar": (ar16, ar32)}


def test_faceformer_coeff_bf16_forward_matches_jax(coeff):
    """The teacher-forced forward, the condition merge included; the
    parameters stay float32 and no kernel is launched on the CPU."""
    tm = coeff["model"]
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    _no_launch()
    with torch.no_grad():
        got = tm(*_t(*coeff["inputs"]))
    assert got.dtype == torch.bfloat16
    assert kb.launches + kb.launches_bf16 + kba.launches + kba.launches_bf16 == 0
    assert_closer("FaceFormerCoeff bf16 forward", got, *coeff["tf"])


def test_faceformer_coeff_bf16_predict_matches_jax(coeff):
    audio, coeffs, *cond = coeff["inputs"]
    got = coeff["model"].predict(torch.from_numpy(audio), coeffs.shape[1], *_t(*cond))
    assert got.dtype == torch.bfloat16
    assert_closer("FaceFormerCoeff bf16 predict", got, *coeff["ar"])


def test_faceformer_coeff_bf16_merge_condition_matches_jax(coeff):
    """``merge_condition`` alone: the float32 embeddings cast by the merge's
    Dense, as in JAX."""
    cfg = jff.FaceFormerConfig.tiny()
    hidden = np.random.default_rng(3).standard_normal((2, 12, cfg.feature_dim)).astype(np.float32)
    _, _, *cond = coeff["inputs"]

    def merge(params, h, *c):
        return [jff.FaceFormerCoeff(cfg, dtype=dt).apply(params, h, *c, method="merge_condition")
                for dt in (BF, jnp.float32)]

    ref16, ref32 = exact_jit(merge, coeff["params"], hidden.astype(BF), *cond)
    with torch.no_grad():
        got = coeff["model"].merge_condition(torch.from_numpy(hidden).bfloat16(), *_t(*cond))
    assert got.dtype == torch.bfloat16
    assert_closer("FaceFormerCoeff bf16 merge_condition", got, ref16, ref32)


def test_ar_decode_bf16_matches_jax(coeff):
    """The KV-cached decode alone on the decoder layer and heads of the
    model, from the same bfloat16 memory and start token."""
    tm, params = coeff["model"], coeff["params"]["params"]
    cfg = jff.FaceFormerConfig.tiny()
    B, T, D = 2, 12, cfg.feature_dim
    rng = np.random.default_rng(5)
    memory = np.array(jnp.asarray(rng.standard_normal((B, T, D)), BF).astype(jnp.float32))
    token0 = np.array(jnp.asarray(rng.standard_normal((B, D)), BF).astype(jnp.float32))

    def decode(p, m, t):
        return [jar.ar_decode(p["transformer_decoder"]["layers_0"], m.astype(dt), t.astype(dt),
                              p["vertice_map_r"], p["vertice_map"], cfg.nhead, cfg.period)
                for dt in (BF, jnp.float32)]

    ref16, ref32 = exact_jit(decode, params, memory, token0)
    got = tar.ar_decode(tm.transformer_decoder.layers[0], torch.from_numpy(memory).bfloat16(),
                        torch.from_numpy(token0).bfloat16(), tm.vertice_map_r, tm.vertice_map,
                        cfg.nhead, cfg.period)
    assert got.dtype == torch.bfloat16
    assert_closer("ar_decode bf16", got, ref16, ref32)


# ---- FaceFormerVert -------------------------------------------------------

def test_faceformer_vert_bf16_forward_and_predict_match_jax():
    """The tiny vertex model with a template, its default one-hot subject
    and eye embedding at the compute dtype: the forward and ``predict``."""
    cfg = jffv.FaceFormerVertConfig.tiny()
    rng = np.random.default_rng(0)
    template = (rng.standard_normal(cfg.vertice_dim) * 0.1).astype(np.float32)
    B, T = 3, 10
    audio = rng.standard_normal((B, T * 640)).astype(np.float32)
    verts = rng.standard_normal((B, T, cfg.vertice_dim)).astype(np.float32)
    emo = rng.standard_normal((B, T, cfg.emo_dim)).astype(np.float32)
    tpl = jnp.asarray(template)
    params = _random_params(jffv.FaceFormerVert(cfg, template=tpl), 3, audio, verts, emo)
    run = _both(lambda dt: jffv.FaceFormerVert(cfg, template=tpl, dtype=dt),
                lambda a, v, e: ((a, v, e), (a, T, e)))
    (tf32, ar32), (tf16, ar16) = exact_jit(run, params, audio, verts, emo)
    tm = tffv.FaceFormerVert.random_init(tffv.FaceFormerVertConfig.tiny(),
                                         template=torch.from_numpy(template), device="cpu",
                                         dtype=torch.bfloat16)
    tm.load_state_dict({k: torch.as_tensor(v)
                        for k, v in faceformer_vert_state_from_jax(params["params"]).items()})
    with torch.no_grad():
        got_tf = tm(*_t(audio, verts, emo))
    got_ar = tm.predict(torch.from_numpy(audio), T, torch.from_numpy(emo))
    assert got_tf.dtype == got_ar.dtype == torch.bfloat16
    assert_closer("FaceFormerVert bf16 forward", got_tf, tf16, tf32)
    assert_closer("FaceFormerVert bf16 predict", got_ar, ar16, ar32)


# ---- the positional tables at bfloat16 ------------------------------------

def test_positional_tables_bit_equal_at_bf16():
    """The PPE, the ALiBi bias and the alignment bias built at bfloat16, as
    JAX builds them at ``dtype=jnp.bfloat16``."""
    pairs = [
        (tpos.periodic_positional_encoding(30, 32, 5, torch.bfloat16),
         jpos.periodic_positional_encoding(30, 32, 5, BF)),
        (tpos.faceformer_bias(4, 30, 5, dtype=torch.bfloat16),
         jpos.faceformer_bias(4, 30, 5, dtype=BF)),
        (tpos.enc_dec_alignment_bias(30, 30, 1, dtype=torch.bfloat16),
         jpos.enc_dec_alignment_bias(30, 30, 1, dtype=BF)),
    ]
    for got, ref in pairs:
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
