"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped without a card (a CUDA kernel has no CPU mode).
The file imports neither JAX nor the JAX package, so it also runs on a
machine with a card and no JAX, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb

CASES = [
    # B, H, T, S, d, valid key lengths per batch
    (3, 4, 24, 24, 8, (8, 16, 24)),  # distinct per-batch masks
    (2, 2, 16, 40, 16, (40, 5)),  # T != S
    (2, 3, 13, 13, 8, (13, 6)),  # T not a multiple of 8
    (1, 12, 200, 200, 64, (200,)),  # generate's shape
    (2, 12, 512, 512, 64, (512, 300)),  # largest length bucket
    (1, 2, 70, 130, 128, (97,)),  # widest head taken
]


def _cuda_inputs(B, H, T, S, d, lens, seed=2):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, T, d)) * d ** -0.5).astype(np.float32)
    k = rng.standard_normal((B, H, S, d)).astype(np.float32)
    v = rng.standard_normal((B, H, S, d)).astype(np.float32)
    bias = np.where(np.arange(S)[None] < np.asarray(lens)[:, None], 0.0, -1e9).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (q, k, v, bias)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,S,d,lens", CASES)
def test_keybias_kernel_matches_plain_version(B, H, T, S, d, lens):
    """fp32 kernel vs plain version: < 1e-5; one launch counted."""
    q, k, v, bias = _cuda_inputs(B, H, T, S, d, lens)
    before = kb.launches
    got = kb.keybias_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert kb.launches == before + 1
    torch.testing.assert_close(got, kb.keybias_attention_reference(q, k, v, bias),
                               atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_keybias_kernel_refuses_what_it_does_not_take():
    q, k, v, bias = _cuda_inputs(1, 2, 16, 16, 16, (16,))
    with pytest.raises(NotImplementedError, match="training"):
        kb.keybias_attention(q.clone().requires_grad_(), k, v, bias)
    with pytest.raises(TypeError):
        kb.keybias_attention(q.half(), k.half(), v.half(), bias.half())
    with pytest.raises(ValueError):  # head_dim not a multiple of 8
        kb.keybias_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                             v[..., :12].contiguous(), bias)
    with pytest.raises(ValueError):  # not contiguous
        kb.keybias_attention(q.transpose(2, 3), k, v, bias)
