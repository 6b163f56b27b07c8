"""Port parity, ops: resample, positional encodings, transformer encoder.

The same numpy inputs and weights go through the JAX function and its
counterpart in avi_talking_tpu_torch on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.ops import positional as jpos
from avi_talking_tpu.ops.resample import linear_interpolate as j_interp
from avi_talking_tpu.ops.transformer import TransformerEncoder as JEncoder
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.infra.jax_params import transformer_encoder_state_from_jax
from avi_talking_tpu_torch.ops import positional as tpos
from avi_talking_tpu_torch.ops.resample import linear_interpolate as t_interp
from avi_talking_tpu_torch.ops.transformer import TransformerEncoder as TEncoder
from _torch_threads import one_torch_thread  # noqa: F401


def _port(factory, state):
    m = random_module(factory, torch.device("cpu"), torch.Generator().manual_seed(0))
    m.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return m


@pytest.mark.parametrize("in_len,out_len,axis", [
    (100, 50, 1), (101, 50, 1), (49, 25, 1), (400, 200, 1), (7, 19, 1),
    (10, 1, 1), (1, 6, 1), (12, 12, 1), (33, 16, 0), (64, 17, 2),
])
def test_linear_interpolate_matches_jax(in_len, out_len, axis):
    """align_corners linear resample: < 1e-5 (it sets lip sync)."""
    shape = [3, 5, 4]
    shape[axis] = in_len
    x = np.random.default_rng(in_len + out_len).standard_normal(shape).astype(np.float32)
    ref = np.asarray(j_interp(jnp.asarray(x), out_len, axis=axis))
    got = t_interp(torch.from_numpy(x), out_len, axis=axis).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 64), (8, 20)])
def test_t5_bucket_is_exact(num_buckets, max_distance):
    rel = np.arange(-400, 401, dtype=np.int32)
    ref = np.asarray(jpos.t5_relative_position_bucket(jnp.asarray(rel), num_buckets, max_distance))
    got = tpos.t5_relative_position_bucket(torch.from_numpy(rel), num_buckets, max_distance).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("length,d,period", [(50, 16, 30), (7, 10, 3), (128, 128, 25)])
def test_positional_tables_match_jax(length, d, period):
    np.testing.assert_array_equal(
        tpos.sinusoidal_positional_encoding(length, d).numpy(),
        np.asarray(jpos.sinusoidal_positional_encoding(length, d)))
    np.testing.assert_array_equal(
        tpos.periodic_positional_encoding(length, d, period).numpy(),
        np.asarray(jpos.periodic_positional_encoding(length, d, period)))


@pytest.mark.parametrize("activation,bias_kind", [
    ("gelu", None), ("relu", "2d"), ("gelu", "4d"), ("leaky_relu", "3d"),
])
def test_transformer_encoder_matches_jax(activation, bias_kind):
    """Post-LN encoder (flax LayerNorm eps 1e-6, packed in_proj): < 1e-5."""
    B, T, D, H, F = 2, 11, 16, 4, 32
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    bias = {
        None: None,
        "2d": np.where(np.tril(np.ones((T, T))) > 0, 0.0, -1e9).astype(np.float32),
        "3d": rng.standard_normal((H, T, T)).astype(np.float32),
        "4d": np.where(np.arange(T)[None, None, None] < np.array([7, 11])[:, None, None, None],
                       0.0, -1e9).astype(np.float32),
    }[bias_kind]
    jm = JEncoder(num_layers=2, d_model=D, nhead=H, dim_feedforward=F, activation=activation)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    jb = None if bias is None else jnp.asarray(bias)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jb))
    tm = _port(lambda: TEncoder(2, D, H, F, activation),
               transformer_encoder_state_from_jax(jax.tree.map(np.asarray, params["params"])))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), None if bias is None else torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_transformer_layer_norm_epsilon_is_flax_default():
    tm = TEncoder(1, 8, 2, 16)
    assert tm.layers[0].norm1.eps == 1e-6 and tm.layers[0].norm2.eps == 1e-6
