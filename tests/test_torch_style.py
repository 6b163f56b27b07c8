"""Port parity, style branch: tokenizer, CLIP text tower, brain network,
prior network and both samplers at the tiny config.

jax.random streams cannot be reproduced in torch, so the sampler tests
rebuild JAX's draws with jax.random (mirroring the key splits of
DiffusionPrior.p_sample_loop / ddim_sample_loop) and hand them to the port
as explicit noise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.models import brain as jbrain
from avi_talking_tpu.models import clip_text as jclip
from avi_talking_tpu.models import diffusion as jdiff
from avi_talking_tpu.models import prior_transformer as jprior
from avi_talking_tpu.pipeline import generate as jgen
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.infra.jax_params import (
    brain_state_from_jax,
    clip_text_state_from_jax,
    prior_state_from_jax,
)
from avi_talking_tpu_torch.models import brain as tbrain
from avi_talking_tpu_torch.models import clip_text as tclip
from avi_talking_tpu_torch.models import diffusion as tdiff
from avi_talking_tpu_torch.models import prior_transformer as tprior
from avi_talking_tpu_torch.pipeline import generate as tgen
from _torch_threads import one_torch_thread  # noqa: F401

INSTRUCTIONS = [
    "A fairly angry man speaks with brow fairly down",
    "a happy person, smiling; lips parted!",
    "",
    "Sad woman 3 times... don't",
]


def _port(factory, state):
    m = random_module(factory, torch.device("cpu"), torch.Generator().manual_seed(0))
    m.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return m


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_full_width_tokenizer_ids_match_jax():
    cfg = jgen.PipelineConfig()
    jtok = jgen.load_tokenizer(cfg.clip.vocab_size, cfg.max_tokens)
    ttok = tgen.load_tokenizer(cfg.clip.vocab_size, cfg.max_tokens)
    ids = np.asarray(ttok(INSTRUCTIONS))
    assert ids.shape == (len(INSTRUCTIONS), 77)
    np.testing.assert_array_equal(ids, np.asarray(jtok(INSTRUCTIONS)))


def test_clip_text_matches_jax():
    """Last hidden state < 1e-4 (eps 1e-5, quick_gelu, -1e9 causal bias)."""
    cfg = jclip.ClipTextConfig.tiny()
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 16)).astype(np.int32)
    jm = jclip.ClipTextModel(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ids))
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(ids)))
    tm = _port(lambda: tclip.ClipTextModel(tclip.ClipTextConfig.tiny()),
               clip_text_state_from_jax(_np(params["params"])))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_brain_matches_jax():
    """Embedding and projector outputs < 1e-4 (flax LayerNorm eps 1e-6)."""
    kw = dict(out_dim=32, in_dim=32, clip_size=32, hidden=64, n_blocks=2)
    x = np.random.default_rng(1).standard_normal((3, 32)).astype(np.float32)
    jm = jbrain.BrainNetwork(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = jax.jit(jm.apply)(params, jnp.asarray(x))
    tm = _port(lambda: tbrain.BrainNetwork(**kw), brain_state_from_jax(_np(params["params"])))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=0)
    assert tm.lin0[1].eps == 1e-6


@pytest.fixture(scope="module")
def prior_pair():
    dim, depth, heads, dh = 32, 2, 2, 8
    net = jprior.PriorTransformerNetwork(dim=dim, depth=depth, heads=heads, dim_head=dh)
    params = jax.jit(net.init)(jax.random.PRNGKey(2), jnp.zeros((1, 1, dim)),
                               jnp.zeros((1,), jnp.int32), jnp.zeros((1, dim)))
    params = _np(params)
    tnet = _port(lambda: tprior.PriorTransformerNetwork(dim=dim, depth=depth, heads=heads,
                                                        dim_head=dh),
                 prior_state_from_jax(params["params"]))
    sched_steps = 10
    jp = jdiff.DiffusionPrior(net=net, scheduler=jdiff.NoiseScheduler.create(sched_steps))
    tp = tdiff.DiffusionPrior(net=tnet, scheduler=tdiff.NoiseScheduler.create(sched_steps))
    return jp, params, tp


@pytest.mark.parametrize("cond_scale", [1.0, 2.5])
def test_prior_net_matches_jax(prior_pair, cond_scale):
    """x0 prediction < 1e-4, with and without the null-embedding pass."""
    jp, params, tp = prior_pair
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1, 32)).astype(np.float32)
    text = rng.standard_normal((3, 32)).astype(np.float32)
    t = np.array([0, 4, 9], np.int32)
    ref = np.asarray(jp.net.forward_with_cond_scale(params, jnp.asarray(x), jnp.asarray(t),
                                                    jnp.asarray(text), cond_scale))
    with torch.no_grad():
        got = tp.net.forward_with_cond_scale(torch.from_numpy(x), torch.from_numpy(t),
                                             torch.from_numpy(text), cond_scale).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_noise_schedule_is_identical():
    for name, a in vars(jdiff.NoiseScheduler.create(100)).items():
        np.testing.assert_array_equal(getattr(tdiff.NoiseScheduler.create(100), name), a)


def jax_ddpm_noise(key, shape, steps):
    """The draws of jax DiffusionPrior.p_sample_loop for ``key``."""
    k_init, k_loop = jax.random.split(key)
    init = jax.random.normal(k_init, shape)
    draws = []
    for _ in range(steps):
        k_loop, k_noise = jax.random.split(k_loop)
        draws.append(jax.random.normal(k_noise, shape, jnp.float32))
    return np.asarray(init), np.stack([np.asarray(d) for d in draws])


def jax_ddim_noise(key, shape):
    k_init, _ = jax.random.split(key)
    return np.asarray(jax.random.normal(k_init, shape))


@pytest.mark.parametrize("cond_scale", [1.0, 2.0])
def test_p_sample_loop_matches_jax(prior_pair, cond_scale):
    """Whole DDPM loop < 1e-4 with JAX's own draws."""
    jp, params, tp = prior_pair
    shape = (2, 1, 32)
    text = np.random.default_rng(4).standard_normal((2, 32)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax.jit(lambda p, te, k: jp.p_sample_loop(p, shape, te, k, cond_scale=cond_scale))(
        params, jnp.asarray(text), key))
    init, steps = jax_ddpm_noise(key, shape, 10)
    with torch.no_grad():
        got = tp.p_sample_loop(shape, torch.from_numpy(text), cond_scale=cond_scale,
                               noise_init=torch.from_numpy(init),
                               noise_steps=torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("steps,cond_scale", [(5, 1.0), (10, 3.0)])
def test_ddim_sample_loop_matches_jax(prior_pair, steps, cond_scale):
    jp, params, tp = prior_pair
    shape = (2, 1, 32)
    text = np.random.default_rng(5).standard_normal((2, 32)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    ref = np.asarray(jax.jit(lambda p, te, k: jp.ddim_sample_loop(
        p, shape, te, k, steps=steps, cond_scale=cond_scale))(params, jnp.asarray(text), key))
    with torch.no_grad():
        got = tp.ddim_sample_loop(shape, torch.from_numpy(text), steps=steps,
                                  cond_scale=cond_scale,
                                  noise_init=torch.from_numpy(jax_ddim_noise(key, shape))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def jax_ddim_eta_noise(key, shape, steps):
    """The draws of jax ``ddim_sample_loop(eta > 0)`` for ``key``: the initial
    noise, then one split of the loop key a step."""
    k_init, k_loop = jax.random.split(key)
    draws = []
    for _ in range(steps):
        k_loop, r = jax.random.split(k_loop)
        draws.append(np.asarray(jax.random.normal(r, shape, jnp.float32)))
    return np.asarray(jax.random.normal(k_init, shape)), np.stack(draws)


@pytest.mark.parametrize("eta,cond_scale", [(0.5, 1.0), (1.0, 2.0)])
def test_ddim_sample_loop_eta_matches_jax(prior_pair, eta, cond_scale):
    """Stochastic DDIM (sigma from ``eta``) < 1e-4 with JAX's own draws, and
    away from the deterministic loop."""
    jp, params, tp = prior_pair
    shape, steps = (2, 1, 32), 5
    text = np.random.default_rng(6).standard_normal((2, 32)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    ref = np.asarray(jax.jit(lambda p, te, k: jp.ddim_sample_loop(
        p, shape, te, k, steps=steps, eta=eta, cond_scale=cond_scale))(
        params, jnp.asarray(text), key))
    init, draws = jax_ddim_eta_noise(key, shape, steps)
    with torch.no_grad():
        got = tp.ddim_sample_loop(shape, torch.from_numpy(text), steps=steps,
                                  cond_scale=cond_scale, eta=eta,
                                  noise_init=torch.from_numpy(init),
                                  noise_steps=torch.from_numpy(draws)).numpy()
        plain = tp.ddim_sample_loop(shape, torch.from_numpy(text), steps=steps,
                                    cond_scale=cond_scale,
                                    noise_init=torch.from_numpy(init)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert np.abs(got - plain).max() > 1e-2


@pytest.mark.parametrize("field,value", [
    ("image_embed_scale", 2.5),
    ("sampling_clamp_l2norm", True),
    ("init_image_embed_l2norm", True),
    ("sampling_final_clamp_l2norm", True),
])
def test_sampler_l2norm_fields_match_jax(prior_pair, field, value):
    """Each of the prior's four sampling options, set alone, through the
    DDPM and the DDIM loop < 1e-4 with JAX's own draws."""
    jp, params, tp = prior_pair
    jp = dataclasses.replace(jp, **{field: value})
    tp = dataclasses.replace(tp, **{field: value})
    shape = (2, 1, 32)
    text = np.random.default_rng(7).standard_normal((2, 32)).astype(np.float32)
    key = jax.random.PRNGKey(14)
    ref_ddpm = np.asarray(jax.jit(lambda p, te, k: jp.p_sample_loop(p, shape, te, k))(
        params, jnp.asarray(text), key))
    ref_ddim = np.asarray(jax.jit(lambda p, te, k: jp.ddim_sample_loop(p, shape, te, k, steps=3))(
        params, jnp.asarray(text), key))
    init, steps = jax_ddpm_noise(key, shape, 10)
    with torch.no_grad():
        got_ddpm = tp.p_sample_loop(shape, torch.from_numpy(text), noise_init=torch.from_numpy(init),
                                    noise_steps=torch.from_numpy(steps)).numpy()
        got_ddim = tp.ddim_sample_loop(shape, torch.from_numpy(text), steps=3,
                                       noise_init=torch.from_numpy(jax_ddim_noise(key, shape))).numpy()
    np.testing.assert_allclose(got_ddpm, ref_ddpm, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_ddim, ref_ddim, atol=1e-4, rtol=0)


def test_sampler_draws_from_generator_when_no_noise(prior_pair):
    _, _, tp = prior_pair
    text = torch.zeros(1, 32)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return tp.p_sample_loop((1, 1, 32), text, generator=g)

    torch.testing.assert_close(run(1), run(1), atol=0, rtol=0)
    assert not torch.equal(run(1), run(2))


def test_clip_config_matches_jax():
    assert dataclasses.asdict(tclip.ClipTextConfig()) == dataclasses.asdict(jclip.ClipTextConfig())
    assert dataclasses.asdict(tclip.ClipTextConfig.tiny()) == dataclasses.asdict(
        jclip.ClipTextConfig.tiny())


def test_hash_tokenizer_fallback_matches_jax():
    texts = ["a happy person", "", "Ünïcode words and MORE words than fit in here"]
    np.testing.assert_array_equal(tgen._HashTokenizer(99, 8)(texts),
                                  jgen._HashTokenizer(99, 8)(texts))
