"""Port parity, the whole slice: ``generate`` and ``generate_batch`` of the
tiny pipeline in JAX and in the port, on the same weights (carried by
infra.jax_params) and the same prior noise (JAX's own draws, handed to the
port explicitly)."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.core import assets as jassets
from avi_talking_tpu.models.brain import BrainNetwork
from avi_talking_tpu.models.clip_text import ClipTextModel
from avi_talking_tpu.models.diffusion import DiffusionPrior, NoiseScheduler
from avi_talking_tpu.models.emote import EmoteTalkingHead
from avi_talking_tpu.models.prior_transformer import PriorTransformerNetwork
from avi_talking_tpu.pipeline import generate as jgen
from avi_talking_tpu_torch.core import assets as tassets
from avi_talking_tpu_torch.infra.jax_params import pipeline_state_from_jax
from avi_talking_tpu_torch.pipeline import Intervals as TIntervals
from avi_talking_tpu_torch.pipeline import generate as tgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTRUCTION = "A fairly angry man speaks with brow fairly down"


def _jax_pipeline(cfg, flame_assets, seed=0):
    """``jgen.AviTalkingPipeline.random_init`` with each init jitted (the
    eager inits take about a minute on the CPU); same keys, same modules,
    same tokenizer resolution."""
    r_clip, r_brain, r_prior, r_head = jax.random.split(jax.random.PRNGKey(seed), 4)
    clip_model = ClipTextModel(cfg.clip)
    clip_params = jax.jit(clip_model.init)(r_clip, jnp.zeros((1, cfg.max_tokens), jnp.int32))
    brain = BrainNetwork(out_dim=cfg.clip_size, in_dim=cfg.clip.hidden_size, clip_size=cfg.clip_size)
    brain_params = jax.jit(brain.init)(r_brain, jnp.zeros((1, cfg.clip.hidden_size)))
    net = PriorTransformerNetwork(dim=cfg.clip_size, depth=cfg.prior_depth,
                                  heads=cfg.prior_heads, dim_head=cfg.prior_dim_head)
    prior_params = jax.jit(net.init)(r_prior, jnp.zeros((1, 1, cfg.clip_size)),
                                     jnp.zeros((1,), jnp.int32), jnp.zeros((1, cfg.clip_size)))
    prior = DiffusionPrior(net=net, scheduler=NoiseScheduler.create(cfg.timesteps),
                           text_cond_drop_prob=cfg.cond_drop_prob,
                           image_cond_drop_prob=cfg.cond_drop_prob)
    head = EmoteTalkingHead(cfg.emote, flame_assets=flame_assets)
    lfs = cfg.emote.flint.latent_frame_size
    head_params = jax.jit(lambda k: head.init(
        k, jnp.zeros((1, lfs, 640)), style_emb=jnp.zeros((1, cfg.emote.feature_dim))))(r_head)
    params = {"clip": clip_params, "brain": brain_params, "prior": prior_params,
              "head": head_params}
    # non-trivial norm affines, LucidLayerNorm gains and BatchNorm stats
    rng = np.random.default_rng(seed + 1)

    def bump(path, a):
        a = np.asarray(a)
        key = path[-1].key
        if key == "var":
            return (0.5 + rng.random(a.shape)).astype(np.float32)
        if key in ("mean", "scale", "bias", "g"):
            return (a + rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(bump, params)
    return jgen.AviTalkingPipeline(
        cfg=cfg, clip_model=clip_model, brain=brain, prior=prior, head=head,
        params=jax.tree.map(jnp.asarray, params),
        tokenizer=jgen.load_tokenizer(cfg.clip.vocab_size, cfg.max_tokens))


@pytest.fixture(scope="module")
def pipes():
    akw = dict(n_shape=8, n_exp=6)
    jp = _jax_pipeline(jgen.PipelineConfig.tiny(), jassets.synthetic_assets(**akw))
    tp = tgen.AviTalkingPipeline.random_init(
        tgen.PipelineConfig.tiny(), tassets.synthetic_assets(**akw), seed=5, device="cpu")
    tp.load_state_dict(pipeline_state_from_jax(jax.tree.map(np.asarray, jp.params)))
    return jp, tp


def _ddpm_noise(seed, shape, steps):
    """The draws of jax DiffusionPrior.p_sample_loop under PRNGKey(seed)."""
    k_init, k_loop = jax.random.split(jax.random.PRNGKey(seed))
    init = np.asarray(jax.random.normal(k_init, shape))
    draws = []
    for _ in range(steps):
        k_loop, k_noise = jax.random.split(k_loop)
        draws.append(np.asarray(jax.random.normal(k_noise, shape, jnp.float32)))
    return {"init": init, "steps": np.stack(draws)}


def _ddim_noise(seed, shape):
    k_init, _ = jax.random.split(jax.random.PRNGKey(seed))
    return {"init": np.asarray(jax.random.normal(k_init, shape))}


def _wav(n, seed):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, n).astype(np.float32)


def _assert_outputs_close(got, ref, keys=("exp", "jaw", "style_emb", "vertices")):
    for key in keys:
        assert got[key].shape == np.asarray(ref[key]).shape, key
        np.testing.assert_allclose(got[key], np.asarray(ref[key]), atol=1e-4, rtol=0,
                                   err_msg=key)
    np.testing.assert_array_equal(got["frames"], ref["frames"])


@pytest.mark.parametrize("sampler,cond_scale,with_intervals", [
    ("ddpm", 1.0, False),
    ("ddim", 1.0, False),
    ("ddpm", 2.0, False),
    ("ddpm", 1.0, True),
])
def test_generate_matches_jax(pipes, sampler, cond_scale, with_intervals):
    """exp / jaw / vertices / style_emb < 1e-4 end to end."""
    jp, tp = pipes
    wav, seed = _wav(16000, 0), 3
    kw = dict(seed=seed, cond_scale=cond_scale, sampler=sampler, ddim_steps=4)
    iv = dict(mouth_opening=((2, 7),), mouth_closure=((12, 17),), silent=((0, 2),))
    ref = jp.generate(wav, INSTRUCTION,
                      intervals=jgen.Intervals(**iv) if with_intervals else None, **kw)
    shape = (1, 1, tp.cfg.clip_size)
    noise = (_ddim_noise(seed, shape) if sampler == "ddim"
             else _ddpm_noise(seed, shape, tp.cfg.timesteps))
    got = tp.generate(wav, INSTRUCTION, intervals=TIntervals(**iv) if with_intervals else None,
                      noise=noise, **kw)
    assert got["exp"].shape == (28, 6) and got["vertices"].shape == (28, 128, 3)
    _assert_outputs_close(got, ref)
    if with_intervals:
        np.testing.assert_array_equal(got["jaw"][0:2], 0.0)


def test_generate_batch_matches_jax(pipes):
    """Mixed lengths over two buckets (64 and 128 frames), valid_len masks:
    every clip < 1e-4, and the same stage_times keys."""
    jp, tp = pipes
    wavs = [_wav(16000, 1), _wav(48000, 2), _wav(9600, 3)]
    instr = [INSTRUCTION, "a happy person", "sad"]
    seed = 4
    jst, tst = {}, {}
    ref = jp.generate_batch(wavs, instr, seed=seed, stage_times=jst)
    got = tp.generate_batch(wavs, instr, seed=seed, stage_times=tst,
                            noise=_ddpm_noise(seed, (3, 1, tp.cfg.clip_size), tp.cfg.timesteps))
    assert [g["exp"].shape[0] for g in got] == [28, 76, 16]
    for g, r in zip(got, ref):
        _assert_outputs_close(g, r)
    assert set(tst) == set(jst) == {"framing_ms", "style_dispatch_ms", "prep_ms",
                                    "device_fetch_ms"}
    no_verts = tp.generate_batch(wavs[:1], instr[:1], return_vertices=False)
    assert "vertices" not in no_verts[0] and no_verts[0]["exp"].shape == (28, 6)


def test_tokenizer_ids_match_jax_pipeline(pipes):
    jp, tp = pipes
    texts = [INSTRUCTION, "a happy person, smiling; lips parted!", "", "Sad woman 3 times..."]
    np.testing.assert_array_equal(np.asarray(tp.tokenizer(texts)), np.asarray(jp.tokenizer(texts)))


def test_generate_is_deterministic_per_seed(pipes):
    _, tp = pipes
    wav = np.zeros(8000, np.float32)
    a = tp.generate(wav, "happy", seed=1)
    b = tp.generate(wav, "happy", seed=1)
    c = tp.generate(wav, "happy", seed=2)
    np.testing.assert_array_equal(a["style_emb"], b["style_emb"])
    assert not np.allclose(a["style_emb"], c["style_emb"])


def test_random_init_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgen.AviTalkingPipeline.random_init(tgen.PipelineConfig.tiny())


def test_pipeline_config_matches_jax():
    def norm(cfg):
        d = dataclasses.asdict(cfg)
        d["emote"]["wav2vec2"].pop("use_pallas_attention", None)
        return d

    assert norm(tgen.PipelineConfig()) == norm(jgen.PipelineConfig())
    assert norm(tgen.PipelineConfig.tiny()) == norm(jgen.PipelineConfig.tiny())


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without pulling
    in jax, flax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import avi_talking_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'avi_talking_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('avi_talking_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # viz, cli (the importers too), data, the trainers, the host codecs' build and binding,
    # PIRender with its losses, discriminators, trainer and data, EMOCA / DECA's encoders,
    # detail branch, losses, trainer, mesh IO and train-emoca, the preprocessing nets and
    # data (FAN landmarks, S3FD, BiSeNet, face crops, yuv, video, preprocess-mead), the BFM
    # visualizer, ResNetSE, the SER head, the preprocessors, CelebV and caption translation,
    # the FLINT VAE, the ablation decoders and sequence encoders, SpecAugment, the loop
    # utilities, the config and guard modules, the parallel layer and its dry run
    assert int(out.stdout.strip()) >= 127


@pytest.mark.parametrize("start,end", [(10, 10), (0, 7), (6, 0)])
def test_padded_silence_recipe_matches_jax(start, end):
    assert dataclasses.asdict(TIntervals.for_padded_silence(start, end)) == dataclasses.asdict(
        jgen.Intervals.for_padded_silence(start, end))


def test_butter_lowpass_matches_jax():
    from avi_talking_tpu.pipeline import postprocess as jpost
    from avi_talking_tpu_torch.pipeline import postprocess as tpost

    x = np.random.default_rng(3).standard_normal((60, 3)).astype(np.float32)
    np.testing.assert_array_equal(tpost.butter_lowpass_filtfilt(x), jpost.butter_lowpass_filtfilt(x))
