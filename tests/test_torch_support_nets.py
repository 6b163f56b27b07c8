"""Port parity of the support nets: PD-FGC's ``ResNetSE`` audio encoder
(SAP and ASP) with its reference importer, ``audio.ser.Wav2Vec2SER`` and
the three ``models.preprocessors`` (FLAME, image emotion, speech emotion),
against the JAX package on the same weights; ``atol`` 2e-4 / ``rtol``
1e-3, the JAX suite's for these nets."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.audio import ser as jser
from avi_talking_tpu.audio.wav2vec2 import Wav2Vec2Config as JW2VConfig
from avi_talking_tpu.core import FlameModel as JFlame
from avi_talking_tpu.core import synthetic_assets as jsynthetic
from avi_talking_tpu.models import emoca as jemoca
from avi_talking_tpu.models import preprocessors as jprep
from avi_talking_tpu.models import resnet_se as jrse
from avi_talking_tpu_torch.audio.ser import Wav2Vec2SER
from avi_talking_tpu_torch.audio.wav2vec2 import Wav2Vec2Config
from avi_talking_tpu_torch.core.assets import synthetic_assets
from avi_talking_tpu_torch.core.flame import FlameModel
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.infra.jax_params import (resnet_se_state_from_jax,
                                                    wav2vec2_ser_state_from_jax)
from avi_talking_tpu_torch.models import preprocessors as tprep
from avi_talking_tpu_torch.models import resnet_se as trse
from avi_talking_tpu_torch.models.emoca import EmotionRecognitionModule
from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SE_KW = dict(layers=(1, 2, 1, 1), num_filters=(8, 16, 16, 32), n_out=24, n_mels=16)


def _np_state(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _seeded(factory, seed):
    """Seeded weights, BatchNorm statistics and affine perturbed."""
    m = random_module(factory, CPU, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                n = mod.num_features
                mod.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                mod.running_var.copy_(torch.rand(n, generator=g) * 0.5 + 0.75)
                mod.weight.copy_(torch.rand(n, generator=g) * 0.5 + 0.75)
                mod.bias.copy_(torch.randn(n, generator=g) * 0.1)
    return m


@pytest.fixture(scope="module", params=["SAP", "ASP"])
def resnet_se_case(request):
    kind = request.param
    net = _seeded(lambda: trse.ResNetSE(**SE_KW, encoder_type=kind), 3)
    sd = {"enc." + k: v for k, v in _np_state(net).items()}
    jvars = jrse.resnet_se_params_from_torch(sd, layers=SE_KW["layers"], prefix="enc.")
    jnet = jrse.ResNetSE(layers=(1, 2, 1, 1), num_filters=(8, 16, 16, 32), n_out=24, n_mels=16,
                         encoder_type=kind)
    x = np.random.default_rng(1).standard_normal((2, 16, 40, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: jnet.apply(v, a))(jvars, x))
    return kind, net, sd, jvars, x, want


def test_resnet_se_matches_jax(resnet_se_case):
    kind, net, _, _, x, want = resnet_se_case
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 24)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_resnet_se_importers_round_trip(resnet_se_case):
    kind, net, sd, jvars, _, _ = resnet_se_case
    for got in (trse.resnet_se_state_from_torch(sd, layers=SE_KW["layers"], prefix="enc."),
                resnet_se_state_from_jax(jvars)):
        want = net.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v.numpy(), err_msg=k)
    with torch.device("meta"):
        again = trse.ResNetSE(**SE_KW, encoder_type=kind)
    assert again.fc.in_features == net.fc.in_features == (64 if kind == "SAP" else 128)


def test_resnet_se_refuses_an_unknown_pooling():
    with pytest.raises(ValueError):
        trse.ResNetSE(encoder_type="MAX")


@pytest.fixture(scope="module")
def ser_case():
    """JAX's Wav2Vec2SER at the tiny wav2vec2 (seeded by flax under jit),
    carried to the port."""
    jcfg = JW2VConfig.tiny()
    jnet = jser.Wav2Vec2SER(jcfg, num_labels=5, classifier_proj_size=12)
    audio = np.random.default_rng(2).standard_normal((2, 6400)).astype(np.float32) * 0.1
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(audio))["params"]
    params = jax.tree.map(np.asarray, params)
    want = np.asarray(jax.jit(lambda p, a: jnet.apply({"params": p}, a))(params, audio))
    want_len = np.asarray(jax.jit(lambda p, a: jnet.apply({"params": p}, a, output_len=7))(
        params, audio))
    net = Wav2Vec2SER(Wav2Vec2Config.tiny(), num_labels=5, classifier_proj_size=12).eval()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in
                         wav2vec2_ser_state_from_jax(params).items()})
    return net, params, audio, want, want_len


def test_wav2vec2_ser_matches_jax(ser_case):
    net, _, audio, want, want_len = ser_case
    with torch.no_grad():
        got = net(torch.from_numpy(audio))
        got_len = net(torch.from_numpy(audio), output_len=7)
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got_len.numpy(), want_len, atol=2e-4, rtol=1e-3)


def test_speech_emotion_preprocessor_matches_jax(ser_case):
    net, params, audio, want, _ = ser_case
    jnet = jser.Wav2Vec2SER(JW2VConfig.tiny(), num_labels=5, classifier_proj_size=12)
    ref = jprep.SpeechEmotionRecognitionPreprocessor(jnet, {"params": params})(jnp.asarray(audio))
    with torch.no_grad():
        got = tprep.SpeechEmotionRecognitionPreprocessor(net)(torch.from_numpy(audio))
    assert list(got) == list(ref) == ["gt_audio_emotion_logits"]
    np.testing.assert_allclose(got["gt_audio_emotion_logits"].numpy(),
                               np.asarray(ref["gt_audio_emotion_logits"]), atol=2e-4, rtol=1e-3)


def test_emotion_preprocessor_matches_jax():
    net = _seeded(lambda: EmotionRecognitionModule(n_expression=8), 4)
    jvars = jemoca.emotion_module_params_from_torch(_np_state(net))
    frames = np.random.default_rng(3).uniform(0, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    jmod = jemoca.EmotionRecognitionModule(n_expression=8)
    ref = jax.jit(lambda v, f: jprep.EmotionRecognitionPreprocessor(jmod, v)(f))(jvars, frames)
    with torch.no_grad():
        got = tprep.EmotionRecognitionPreprocessor(net)(torch.from_numpy(frames))
    for k in ("gt_emo_feat_2", "gt_expression_logits"):
        assert got[k].shape == ref[k].shape == (2, 3, 2048 if k == "gt_emo_feat_2" else 8)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("per_frame_shape", [False, True])
def test_flame_preprocessor_matches_jax(per_frame_shape):
    rng = np.random.default_rng(5)
    B, T = 2, 3
    batch = {"gt_shape": rng.normal(0, 1, (B, T, 8) if per_frame_shape else (B, 8)),
             "gt_exp": rng.normal(0, 1, (B, T, 6)), "gt_jaw": rng.normal(0, 0.1, (B, T, 3))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    flame = FlameModel(synthetic_assets(n_shape=8, n_exp=6), n_shape=8, n_exp=6)
    jflame = JFlame(jsynthetic(n_shape=8, n_exp=6), n_shape=8, n_exp=6)
    ref = jprep.FlamePreprocessor(jflame)({k: jnp.asarray(v) for k, v in batch.items()})
    got = tprep.FlamePreprocessor(flame)({k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(ref)
    for k in ("gt_vertices", "template"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=1e-5)
    assert dataclasses.is_dataclass(tprep.FlamePreprocessor(flame))
