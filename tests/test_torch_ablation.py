"""Port parity, EMOTE's ablation decoders and sequence encoders
(``models.decoders``, ``models.sequence_encoders``): every decoder kind
(``post_bug_fix`` both ways, the FaceFormer temporal bias, each style
operation, ``flame_bert`` through the synthetic FLAME) and every sequence
encoder (the GRU in one and in both directions) against JAX's on JAX's
weights carried by ``infra.jax_params``, at 1e-5. The JAX modules run
eagerly: at these widths that is cheaper than compiling them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.core import assets as jassets
from avi_talking_tpu.models import decoders as jdec
from avi_talking_tpu.models import sequence_encoders as jse
from avi_talking_tpu_torch.core import assets as tassets
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.infra.jax_params import (
    feed_forward_decoder_state_from_jax,
    sequence_encoder_state_from_jax,
)
from avi_talking_tpu_torch.models import decoders as tdec
from avi_talking_tpu_torch.models import sequence_encoders as tse
from _torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
B, T, D, IN = 2, 12, 16, 24


def _noisy(params, seed):
    """Every leaf moved by N(0, 0.3^2): the zero-initialised head and the
    biases then reach the output."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.3).astype(np.float32), params)


def _port(factory, state):
    m = random_module(factory, torch.device("cpu"), torch.Generator().manual_seed(0))
    m.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return m


def _close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.fixture(scope="module")
def flame():
    return (jassets.synthetic_assets(num_vertices=40, n_shape=4, n_exp=6, num_faces=60),
            tassets.synthetic_assets(num_vertices=40, n_shape=4, n_exp=6, num_faces=60))


DECODERS = [
    dict(kind="linear"),
    dict(kind="linear", style_op="cat"),
    dict(kind="mlp"),
    dict(kind="mlp", style_op="style_only"),
    dict(kind="bert"),
    dict(kind="bert", post_bug_fix=False),
    dict(kind="bert", temporal_bias_type="faceformer", period=5, num_layers=2),
    dict(kind="bert", style_op="none"),
    dict(kind="flame_bert", n_exp=6),
    dict(kind="flame_bert", n_exp=6, predict_jaw=False, post_bug_fix=False),
]


@pytest.mark.parametrize("kw", DECODERS, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_decoder_matches_jax(kw, flame):
    """Offsets, or exp / jaw / vertices for ``flame_bert``, within 1e-5."""
    cfg = dict(feature_dim=D, vertices_dim=30, nhead=4, **kw)
    jcfg, tcfg = jdec.DecoderConfig(**cfg), tdec.DecoderConfig(**cfg)
    fa = kw["kind"] == "flame_bert"
    jm = jdec.FeedForwardDecoder(jcfg, flame_assets=flame[0] if fa else None)
    rng = np.random.default_rng(len(DECODERS))
    hidden = rng.standard_normal((B, T, D)).astype(np.float32)
    style = rng.standard_normal((B, D)).astype(np.float32)
    params = _noisy(jm.init(jax.random.PRNGKey(0), jnp.asarray(hidden), jnp.asarray(style)), 1)
    ref = jm.apply(params, jnp.asarray(hidden), jnp.asarray(style))
    tm = _port(lambda: tdec.FeedForwardDecoder(tcfg, flame_assets=flame[1] if fa else None),
               feed_forward_decoder_state_from_jax(params["params"]))
    got = tm(torch.from_numpy(hidden), torch.from_numpy(style))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k])
    if fa:
        assert got["vertices"].shape == (B, T, 40, 3)


def test_decoder_head_starts_at_zero():
    """The seeded head is zero, as JAX's ``zeros`` initialisers."""
    tm = random_module(lambda: tdec.FeedForwardDecoder(tdec.DecoderConfig(
        kind="bert", feature_dim=D, vertices_dim=30, nhead=4)), torch.device("cpu"),
        torch.Generator().manual_seed(0))
    out = tm(torch.randn(B, T, D), torch.randn(B, D))["offsets"]
    assert out.shape == (B, T, 30) and float(out.abs().max()) == 0.0


ENCODERS = [
    ("linear", {}),
    ("transformer", dict(nhead=4)),
    ("transformer", dict(nhead=4, use_pe=False, num_layers=2)),
    ("gru", {}),
    ("gru", dict(bidirectional=False)),
    ("tcn", {}),
    ("tcn", dict(num_layers=2, kernel_size=5)),
]


@pytest.mark.parametrize("name,kw", ENCODERS,
                         ids=lambda v: v if isinstance(v, str) else "-".join(map(str, v.values())))
def test_sequence_encoder_matches_jax(name, kw):
    """(B, T, feature_dim) within 1e-5; the GRU's backward direction reads
    the sequence reversed and returns it in order (a change of one late
    frame moves its early outputs)."""
    jm = jse.sequence_encoder_from_name(name, D, **kw)
    x = np.random.default_rng(3).standard_normal((B, T, IN)).astype(np.float32)
    params = _noisy(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    ref = jm.apply(params, jnp.asarray(x))
    tm = _port(lambda: tse.sequence_encoder_from_name(name, D, input_dim=IN, **kw),
               sequence_encoder_state_from_jax(params["params"]))
    got = tm(torch.from_numpy(x))
    assert got.shape == (B, T, D)
    _close(got, ref)
    if name == "gru":
        x2 = x.copy()
        x2[:, -1] += 1.0
        moved = (tm(torch.from_numpy(x2)) - got).abs()[:, 0].max()
        assert (float(moved) > 0) == kw.get("bidirectional", True)


def test_tcn_is_causal():
    """An input frame moves no earlier output."""
    tm = random_module(lambda: tse.TCNSequenceEncoder(D, input_dim=IN), torch.device("cpu"),
                       torch.Generator().manual_seed(0))
    x = torch.randn(1, T, IN)
    y = x.clone()
    y[:, 7] += 1.0
    d = (tm(y) - tm(x)).abs().amax(-1)[0]
    assert float(d[:7].max()) == 0.0 and float(d[7]) > 0


def test_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(tdec.DecoderConfig)] == [
        f.name for f in dataclasses.fields(jdec.DecoderConfig)]
    assert dataclasses.asdict(tdec.DecoderConfig()) == dataclasses.asdict(jdec.DecoderConfig())
