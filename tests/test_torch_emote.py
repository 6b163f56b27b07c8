"""Port parity, talking head: FLAME on synthetic assets, the FLINT decoder
and the whole EMOTE head (stack-linear and conv squashers) at the tiny
config, weights carried by infra.jax_params."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.core import assets as jassets
from avi_talking_tpu.core import flame as jflame
from avi_talking_tpu.core.rotations import batch_rodrigues as j_rodrigues
from avi_talking_tpu.models import emote as jemote
from avi_talking_tpu.models import flint as jflint
from avi_talking_tpu_torch.core import assets as tassets
from avi_talking_tpu_torch.core import flame as tflame
from avi_talking_tpu_torch.core.rotations import batch_rodrigues as t_rodrigues
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.infra.jax_params import emote_head_state_from_jax, flint_state_from_jax
from avi_talking_tpu_torch.models import emote as temote
from avi_talking_tpu_torch.models import flint as tflint
from _torch_threads import one_torch_thread  # noqa: F401


def _port(factory, state):
    m = random_module(factory, torch.device("cpu"), torch.Generator().manual_seed(0))
    m.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return m


def _perturb_stats(variables, seed):
    """Non-trivial BatchNorm statistics and norm affines, so the mean/var and
    scale/bias maps are exercised."""
    rng = np.random.default_rng(seed)
    v = jax.tree.map(np.asarray, variables)

    def bump(path, a):
        key = path[-1].key
        if key == "var":
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        if key in ("mean", "scale", "bias"):
            return (a + rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(bump, v)


@pytest.mark.parametrize("kw", [
    {}, dict(num_vertices=300, n_shape=10, n_exp=5, num_faces=100, seed=3),
    dict(with_landmarks=False, seed=7),
])
def test_synthetic_assets_bit_equal(kw):
    ja, ta = jassets.synthetic_assets(**kw), tassets.synthetic_assets(**kw)
    for f in dataclasses.fields(ja):
        a, b = getattr(ja, f.name), getattr(ta, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f.name)
            assert b.numpy().dtype == np.asarray(a).dtype


def test_batch_rodrigues_matches_jax():
    aa = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    aa[0] = 0.0
    np.testing.assert_allclose(t_rodrigues(torch.from_numpy(aa)).numpy(),
                               np.asarray(j_rodrigues(jnp.asarray(aa))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_shape,n_exp,scale", [(8, 6, 1.0), (10, 5, 3.0)])
def test_flame_vertices_match_jax(n_shape, n_exp, scale):
    """vertices_only on synthetic assets: < 1e-4."""
    kw = dict(num_vertices=200, n_shape=n_shape, n_exp=n_exp, num_faces=80, seed=1)
    rng = np.random.default_rng(2)
    B = 12
    shape = (rng.standard_normal((B, n_shape)) * scale).astype(np.float32)
    exp = (rng.standard_normal((B, n_exp)) * scale).astype(np.float32)
    pose = (rng.standard_normal((B, 6)) * 0.3).astype(np.float32)
    ref = np.asarray(jflame.FlameModel(jassets.synthetic_assets(**kw), n_shape, n_exp)
                     .vertices_only(jnp.asarray(shape), jnp.asarray(exp), jnp.asarray(pose)))
    got = tflame.FlameModel(tassets.synthetic_assets(**kw), n_shape, n_exp).vertices_only(
        torch.from_numpy(shape), torch.from_numpy(exp), torch.from_numpy(pose)).numpy()
    assert got.shape == ref.shape == (B, 200, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


FLINT_CFGS = [
    dict(feature_dim=32, bottleneck_dim=32, quant_factor=2, nhead=4,
         intermediate_size=64, out_dim=9, n_exp=6),
    dict(feature_dim=16, bottleneck_dim=24, quant_factor=3, nhead=2, intermediate_size=32,
         out_dim=7, n_exp=4, positional_encoding="periodic", pe_period=5,
         post_transformer_proj=True, post_conv_proj=True),
    dict(feature_dim=16, bottleneck_dim=16, quant_factor=1, nhead=4, intermediate_size=16,
         out_dim=5, n_exp=2, positional_encoding="sinusoidal", num_layers=2),
]


@pytest.mark.parametrize("kw", FLINT_CFGS)
def test_flint_decoder_matches_jax(kw):
    """ConvTranspose (inverse of torch_compat's map), replicate pad +
    repeat_interleave, eval BatchNorm, transformer, smoothing conv: < 1e-4."""
    jcfg, tcfg = jflint.FlintConfig(**kw), tflint.FlintConfig(**kw)
    lat = np.random.default_rng(4).standard_normal((2, 5, kw["bottleneck_dim"])).astype(np.float32)
    jm = jflint.FlintDecoder(jcfg)
    v = _perturb_stats(jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(lat)), 1)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(lat)))
    tm = _port(lambda: tflint.FlintDecoder(tcfg), flint_state_from_jax(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(lat)).numpy()
    assert got.shape == ref.shape == (2, 5 * 2 ** kw["quant_factor"], kw["out_dim"])
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("squash_type,squash_before,style_op,valid", [
    ("stack_linear", False, "add", None),
    ("stack_linear", False, "add", (16, 9)),
    ("conv", False, "add", None),
    ("conv", True, "cat", None),
])
def test_emote_head_matches_jax(squash_type, squash_before, style_op, valid):
    """audio + style -> exp / jaw / vertices through the whole tiny head:
    < 1e-4."""
    cfg_kw = dict(squash_type=squash_type, squash_before=squash_before, style_op=style_op)
    jcfg = dataclasses.replace(jemote.EmoteConfig.tiny(), **cfg_kw)
    tcfg = dataclasses.replace(temote.EmoteConfig.tiny(), **cfg_kw)
    akw = dict(n_shape=8, n_exp=6)
    B, T = 2, 16
    rng = np.random.default_rng(6)
    audio = rng.standard_normal((B, T, 640)).astype(np.float32)
    style = rng.standard_normal((B, 32)).astype(np.float32)
    vl = None if valid is None else np.asarray(valid, np.int32)

    jm = jemote.EmoteTalkingHead(jcfg, flame_assets=jassets.synthetic_assets(**akw))
    v = _perturb_stats(jax.jit(lambda k: jm.init(k, jnp.zeros((1, 4, 640)), style_emb=jnp.zeros((1, 32))))(
        jax.random.PRNGKey(0)), 2)
    ref = jax.jit(lambda v_, a, s, l: jm.apply(v_, a, style_emb=s, valid_len=l))(
        v, jnp.asarray(audio), jnp.asarray(style), None if vl is None else jnp.asarray(vl))

    tm = random_module(lambda: temote.EmoteTalkingHead(tcfg), torch.device("cpu"),
                       torch.Generator().manual_seed(0))
    missing, unexpected = tm.load_state_dict(
        {k: torch.as_tensor(x) for k, x in emote_head_state_from_jax(v).items()}, strict=False)
    assert not unexpected and all(k.startswith("style_encoder.") for k in missing)
    tm.flame_assets = tassets.synthetic_assets(**akw)
    with torch.no_grad():
        got = tm(torch.from_numpy(audio), style_emb=torch.from_numpy(style),
                 valid_len=None if vl is None else torch.from_numpy(vl))
    for key in ("exp", "jaw", "style_emb", "vertices"):
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=1e-4, rtol=0,
                                   err_msg=key)


def test_emote_configs_match_jax():
    def norm(d):
        d["wav2vec2"].pop("use_pallas_attention")
        return d

    for make in ("__call__", "tiny"):
        j = getattr(jemote.EmoteConfig, make)() if make == "tiny" else jemote.EmoteConfig()
        t = getattr(temote.EmoteConfig, make)() if make == "tiny" else temote.EmoteConfig()
        assert dataclasses.asdict(t) == norm(dataclasses.asdict(j))
    assert dataclasses.asdict(tflint.FlintConfig()) == dataclasses.asdict(jflint.FlintConfig())


def test_load_flame_assets_matches_jax(tmp_path):
    """npz loading with the reference's shapedirs slice [0:n_shape] ++
    [300:300+n_exp]."""
    rng = np.random.default_rng(8)
    V = 40
    arrays = {
        "v_template": rng.standard_normal((V, 3)).astype(np.float32),
        "shapedirs": rng.standard_normal((V, 3, 310)).astype(np.float32),
        "posedirs": rng.standard_normal((36, V * 3)).astype(np.float32),
        "j_regressor": rng.random((5, V)).astype(np.float32),
        "lbs_weights": rng.random((V, 5)).astype(np.float32),
        "faces": rng.integers(0, V, (30, 3)).astype(np.int32),
        "lmk_faces_idx": rng.integers(0, 30, (10,)).astype(np.int32),
    }
    path = str(tmp_path / "flame.npz")
    np.savez(path, **arrays)
    ja = jassets.load_flame_assets(path, n_shape=6, n_exp=4)
    ta = tassets.load_flame_assets(path, n_shape=6, n_exp=4)
    assert ta.shapedirs.shape == (V, 3, 10)
    for f in dataclasses.fields(ja):
        a, b = getattr(ja, f.name), getattr(ta, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f.name)


def test_style_encoder_matches_jax():
    """One-hot condition -> style embedding (the head's style encoder)."""
    from avi_talking_tpu.models import conditioning as jcond
    from avi_talking_tpu_torch.infra.jax_params import _dense
    from avi_talking_tpu_torch.models import conditioning as tcond

    jc = jcond.StyleCondition.make(emotion_idx=3, intensity_idx=1, identity_idx=5, batch=2)
    tc_ = tcond.StyleCondition.make(emotion_idx=3, intensity_idx=1, identity_idx=5, batch=2)
    np.testing.assert_array_equal(tc_.concat().numpy(), np.asarray(jc.concat()))
    assert tc_.concat().shape[-1] == tcond.DEFAULT_CONDITION_DIM
    jm = jcond.EmotionStyleEncoder(32)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(4), jc.concat()))
    ref = np.asarray(jm.apply(params, jc.concat()))
    tm = _port(lambda: tcond.EmotionStyleEncoder(output_dim=32),
               {"map." + k: v for k, v in _dense(params["params"]["map"]).items()})
    with torch.no_grad():
        got = tm(tc_.concat()).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
