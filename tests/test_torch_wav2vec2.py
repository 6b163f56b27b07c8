"""Port parity, wav2vec2: the tiny config through the JAX model and the port
with weights carried by infra.jax_params, with and without ``valid_len``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.audio import wav2vec2 as jw
from avi_talking_tpu_torch.audio import wav2vec2 as tw
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.infra.jax_params import wav2vec2_state_from_jax
from _torch_threads import one_torch_thread  # noqa: F401


def _port(factory, state):
    m = random_module(factory, torch.device("cpu"), torch.Generator().manual_seed(0))
    m.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return m


@pytest.fixture(scope="module")
def models():
    cfg = jw.Wav2Vec2Config.tiny()
    jm = jw.Wav2Vec2Model(cfg)
    params = jax.jit(lambda key: jm.init(key, jnp.zeros((1, 3200)), output_len=10))(
        jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params["params"])
    # non-trivial norm affines, so a scale/bias mix-up cannot hide
    rng = np.random.default_rng(5)
    np_params = jax.tree_util.tree_map_with_path(
        lambda path, a: (a + rng.standard_normal(a.shape).astype(np.float32) * 0.1
                         if path[-1].key in ("scale", "bias") else a), np_params)
    tm = _port(lambda: tw.Wav2Vec2Model(tw.Wav2Vec2Config.tiny()), wav2vec2_state_from_jax(np_params))
    return jm, {"params": np_params}, tm


@pytest.mark.parametrize("batch,frames,valid", [
    (1, 10, None), (2, 16, (16, 9)), (3, 24, (5, 24, 17)),
])
def test_wav2vec2_matches_jax(models, batch, frames, valid):
    """Features < 1e-4 (group-norm, resample, pos conv, 2 layers)."""
    jm, params, tm = models
    x = np.random.default_rng(frames).standard_normal((batch, frames * 640)).astype(np.float32)
    vl = None if valid is None else np.asarray(valid, np.int32)
    apply = jax.jit(jm.apply, static_argnames=("output_len",))
    ref = np.asarray(apply(params, jnp.asarray(x), output_len=frames,
                           valid_len=None if vl is None else jnp.asarray(vl)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), output_len=frames,
                 valid_len=None if vl is None else torch.from_numpy(vl)).numpy()
    assert got.shape == ref.shape == (batch, frames, 32)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_wav2vec2_native_rate_without_output_len(models):
    jm, params, tm = models
    x = np.random.default_rng(9).standard_normal((1, 6400)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_wav2vec2_resample_false_matches_jax(models):
    """``resample=False`` keeps the native 50 fps frames even with
    ``output_len`` given."""
    jm, params, tm = models
    x = np.random.default_rng(11).standard_normal((2, 6400)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, a: jm.apply(p, a, output_len=5, resample=False))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), output_len=5, resample=False).numpy()
    assert got.shape == ref.shape and got.shape[1] > 5
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("valid", [None, (16, 9)])
def test_wav2vec2_time_mask_matches_jax(models, valid):
    """SpecAugment frames (``compute_mask_indices``, p 0.5, length 2) replaced
    by ``masked_spec_embed`` before the ``valid_len`` zeroing: < 1e-5 on a
    JAX tree holding the embedding (carried by ``wav2vec2_state_from_jax``
    into a ``mask_time=True`` model), and the mask changes the output."""
    from avi_talking_tpu_torch.audio.specaugment import compute_mask_indices

    jm, params, _ = models
    hidden = jw.Wav2Vec2Config.tiny().hidden_size
    embed = np.random.default_rng(12).random(hidden).astype(np.float32)
    mparams = {"params": {**params["params"], "masked_spec_embed": embed}}
    tm = _port(lambda: tw.Wav2Vec2Model(tw.Wav2Vec2Config.tiny(), mask_time=True),
               wav2vec2_state_from_jax(mparams["params"]))
    x = np.random.default_rng(13).standard_normal((2, 16 * 640)).astype(np.float32)
    mask = compute_mask_indices((2, 16), 0.5, 2, rng=np.random.default_rng(3))
    vl = None if valid is None else np.asarray(valid, np.int32)
    ref = np.asarray(jax.jit(lambda p, a, m, v: jm.apply(
        p, a, output_len=16, mask_time_indices=m, valid_len=v))(
        mparams, jnp.asarray(x), jnp.asarray(mask), None if vl is None else jnp.asarray(vl)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), output_len=16, mask_time_indices=torch.from_numpy(mask),
                 valid_len=None if vl is None else torch.from_numpy(vl)).numpy()
        plain = tm(torch.from_numpy(x), output_len=16,
                   valid_len=None if vl is None else torch.from_numpy(vl)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert mask.any() and np.abs(got - plain).max() > 1e-3


def test_wav2vec2_mask_needs_the_embedding(models):
    """A model built without ``mask_time`` has no ``masked_spec_embed`` (every
    existing state dict loads as before) and refuses a mask; a seeded one
    draws it from U[0, 1), as JAX's ``uniform(1.0)``."""
    _, _, tm = models
    assert "masked_spec_embed" not in tm.state_dict()
    with pytest.raises(ValueError, match="mask_time=True"):
        tm(torch.zeros(1, 6400), mask_time_indices=torch.ones(1, 10, dtype=torch.bool))
    seeded = random_module(lambda: tw.Wav2Vec2Model(tw.Wav2Vec2Config.tiny(), mask_time=True),
                           torch.device("cpu"), torch.Generator().manual_seed(0))
    e = seeded.masked_spec_embed.detach()
    assert float(e.min()) >= 0.0 and float(e.max()) < 1.0 and float(e.std()) > 0.1


@pytest.mark.parametrize("k,groups,D", [(16, 2, 32), (128, 16, 64), (5, 1, 8)])
def test_pos_conv_weight_map(k, groups, D):
    """One grouped Conv1d with weight[o, i, t] = kernel[t, i, o] equals the
    JAX group-unrolled conv, trim included."""
    cfg = jw.Wav2Vec2Config.tiny(hidden=D)
    cfg = jw.dataclasses.replace(cfg, num_conv_pos_embeddings=k, num_conv_pos_embedding_groups=groups)
    x = np.random.default_rng(k).standard_normal((2, 21, D)).astype(np.float32)
    jm = jw.PositionalConvEmbedding(cfg)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x)))
    params["params"]["conv"]["bias"] = np.random.default_rng(1).standard_normal(D).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    tcfg = tw.Wav2Vec2Config(hidden_size=D, num_conv_pos_embeddings=k,
                             num_conv_pos_embedding_groups=groups)
    state = wav2vec2_state_from_jax({
        "feature_extractor": {}, "feature_projection": {
            "layer_norm": {"scale": np.ones(512, np.float32), "bias": np.zeros(512, np.float32)},
            "projection": {"kernel": np.zeros((512, D), np.float32)}},
        "pos_conv_embed": params["params"], "encoder_layer_norm": {
            "scale": np.ones(D, np.float32), "bias": np.zeros(D, np.float32)}})
    tm = _port(lambda: tw.PositionalConvEmbedding(tcfg),
               {k_[len("encoder.pos_conv_embed."):]: v for k_, v in state.items()
                if k_.startswith("encoder.pos_conv_embed.")})
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == x.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_config_matches_jax_but_the_tpu_gate():
    """Same fields and defaults as the JAX config, except
    ``use_pallas_attention``: that gate is a TPU measurement and the port
    sends every layer through the CUDA kernel."""
    import dataclasses

    def fields(cls):
        return {f.name: getattr(cls(), f.name) for f in dataclasses.fields(cls)}

    jf = fields(jw.Wav2Vec2Config)
    del jf["use_pallas_attention"]
    assert fields(tw.Wav2Vec2Config) == jf
    tiny_j = dataclasses.asdict(jw.Wav2Vec2Config.tiny())
    del tiny_j["use_pallas_attention"]
    assert dataclasses.asdict(tw.Wav2Vec2Config.tiny()) == tiny_j


@pytest.mark.parametrize("seconds,pad,amp", [(1.0, 8, 0.5), (0.77, 4, 1.7), (2.5, 1, 0.9)])
def test_frontend_framing_matches_jax(seconds, pad, amp):
    """frame_audio (int16 cast with its wrap above 1.0, tail cut, zero pad to
    the multiple) and normalize_audio: bit-equal."""
    from avi_talking_tpu.audio import frontend as jf
    from avi_talking_tpu_torch.audio import frontend as tf

    wav = (np.random.default_rng(int(seconds * 100)).uniform(-1, 1, int(seconds * 16000))
           * amp).astype(np.float32)
    jframes = jf.frame_audio(wav, pad_to_multiple=pad)
    tframes = tf.frame_audio(wav, pad_to_multiple=pad)
    np.testing.assert_array_equal(tframes, jframes)
    assert tframes.dtype == np.int16 and tframes.shape[0] % pad == 0
    np.testing.assert_array_equal(tf.normalize_audio(tframes), jf.normalize_audio(jframes))


@pytest.mark.parametrize("sr,channels,width", [(16000, 1, 2), (22050, 2, 2), (8000, 1, 1)])
def test_read_wav_matches_jax(tmp_path, sr, channels, width):
    import wave

    from avi_talking_tpu.audio import frontend as jf
    from avi_talking_tpu_torch.audio import frontend as tf

    rng = np.random.default_rng(sr)
    n = sr // 4
    if width == 2:
        data = rng.integers(-30000, 30000, (n, channels)).astype("<i2")
    else:
        data = rng.integers(0, 255, (n, channels)).astype(np.uint8)
    path = str(tmp_path / "clip.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(data.tobytes())
    jw_, jsr = jf.read_wav(path)
    tw_, tsr = tf.read_wav(path)
    assert tsr == jsr == 16000
    np.testing.assert_array_equal(tw_, jw_)
