"""Port parity, kernel K1 (key-bias attention).

``keybias_attention_reference`` (the plain version) is held to the JAX
Pallas kernel run in interpret mode, as the JAX suite runs it on the CPU,
and ``keybias_attention`` on CPU tensors must take the plain version without
launching anything. The kernel itself is held to the plain version on the
card by test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.ops.pallas.attention import fused_keybias_attention
from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb

CASES = [
    # B, H, T, S, d, valid key lengths per batch
    (3, 4, 24, 24, 8, (8, 16, 24)),  # distinct per-batch masks
    (2, 2, 16, 40, 16, (40, 5)),  # T != S
    (2, 3, 13, 13, 8, (13, 6)),  # T not a multiple of 8
    (1, 12, 37, 29, 64, (29,)),  # main-path head width, ragged
]


def _inputs(B, H, T, S, d, lens, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, T, d)) * d ** -0.5).astype(np.float32)
    k = rng.standard_normal((B, H, S, d)).astype(np.float32)
    v = rng.standard_normal((B, H, S, d)).astype(np.float32)
    bias = np.where(np.arange(S)[None] < np.asarray(lens)[:, None], 0.0, -1e9).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("B,H,T,S,d,lens", CASES)
def test_reference_matches_jax_pallas_interpret(B, H, T, S, d, lens):
    """Plain version vs the JAX kernel in interpret mode: < 1e-5."""
    q, k, v, bias = _inputs(B, H, T, S, d, lens)
    ref = np.asarray(fused_keybias_attention(*map(jnp.asarray, (q, k, v, bias)), interpret=True))
    got = kb.keybias_attention_reference(*map(torch.from_numpy, (q, k, v, bias))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,H,T,S,d,lens", CASES)
def test_wrapper_on_cpu_takes_plain_version_without_launch(B, H, T, S, d, lens):
    q, k, v, bias = map(torch.from_numpy, _inputs(B, H, T, S, d, lens, seed=1))
    kb.launches = 0
    got = kb.keybias_attention(q, k, v, bias)
    assert kb.launches == 0
    torch.testing.assert_close(got, kb.keybias_attention_reference(q, k, v, bias),
                               atol=0, rtol=0)
