"""Port parity, kernel K1 (key-bias attention).

``keybias_attention_reference`` (the plain version) is held to the JAX
Pallas kernel run in interpret mode, as the JAX suite runs it on the CPU,
and ``keybias_attention`` on CPU tensors must take the plain version without
launching anything. The kernel itself is held to the plain version on the
card by test_torch_kernels_cuda.py."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.ops.pallas.attention import fused_keybias_attention
from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb
from test_torch_bf16 import assert_closer, exact_jit
from _torch_threads import one_torch_thread  # noqa: F401

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


def test_aligned16_copies_only_a_view_off_a_16_byte_boundary():
    """The kernel copies K and V 16 bytes at a time: a view that starts off
    a 16-byte boundary is copied, an aligned tensor passed as it is."""
    base = torch.arange(65, dtype=torch.float32)
    aligned = base[:64]
    assert base.data_ptr() % 16 == 0 and kb.aligned16(aligned) is aligned
    off = base[1:].view(4, 16)
    got = kb.aligned16(off)
    assert off.data_ptr() % 16 == 4 and got.data_ptr() % 16 == 0
    assert got.is_contiguous() and torch.equal(got, off)


def test_kernel_entry_is_bound_once(monkeypatch):
    """build.function sets an entry's ctypes signature on first use and
    hands back the same bound function after (libc's abs stands in for a
    kernel library here)."""
    from avi_talking_tpu_torch.ops.kernels import build

    monkeypatch.setitem(build._loaded, "libc", ctypes.CDLL(None))
    monkeypatch.setattr(build, "_functions", {})
    fn = build.function("libc", "abs", [ctypes.c_int])
    assert fn.argtypes == [ctypes.c_int] and fn.restype is ctypes.c_int
    assert fn(-7) == 7
    assert build.function("libc", "abs", [ctypes.c_int]) is fn
    assert list(build._functions) == [("libc", "abs")]


@pytest.mark.parametrize("B,H,T,S,d,lens", CASES)
def test_wrapper_on_cpu_takes_plain_version_without_launch(B, H, T, S, d, lens):
    q, k, v, bias = map(torch.from_numpy, _inputs(B, H, T, S, d, lens, seed=1))
    kb.launches = 0
    got = kb.keybias_attention(q, k, v, bias)
    assert kb.launches == 0
    torch.testing.assert_close(got, kb.keybias_attention_reference(q, k, v, bias),
                               atol=0, rtol=0)


# ---- bfloat16 q beside a float32 key bias, any head dim ---------------------

F32_BIAS_CASES = [(2, 4, 24, 24, 16, (24, 9)), (1, 12, 37, 29, 64, (29,)),
                  (2, 3, 13, 13, 8, (13, 6)), (2, 2, 16, 40, 33, (40, 5))]


@pytest.fixture(scope="module")
def f32_bias_refs():
    """The Pallas kernel in interpret mode on bfloat16 q, k, v with a
    float32 key bias, and at float32 on the same values, for every case
    (one exact_jit compile for all)."""
    inputs = []
    for B, H, T, S, d, lens in F32_BIAS_CASES:
        q, k, v, bias = _inputs(B, H, T, S, d, lens, seed=d)
        q, k, v = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (q, k, v))
        inputs.append((q, k, v, bias))

    def run(inputs):
        return [[fused_keybias_attention(q.astype(dt), k.astype(dt), v.astype(dt), b,
                                         interpret=True) for dt in (jnp.bfloat16, jnp.float32)]
                for q, k, v, b in inputs]

    return inputs, exact_jit(run, inputs)


@pytest.mark.parametrize("case", range(len(F32_BIAS_CASES)))
def test_reference_bf16_with_f32_key_bias_matches_jax(case, f32_bias_refs):
    """K1's plain version on bfloat16 q, k, v beside a float32 key bias
    (read as float32, as ``_attn_kernel_keybias`` reads it) against the
    Pallas kernel in interpret mode on the same inputs, by
    test_torch_bf16's rule; the wrapper on the CPU gives the same tensor."""
    inputs, refs = f32_bias_refs
    q, k, v, bias = (torch.from_numpy(a) for a in inputs[case])
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    assert bias.dtype == torch.float32
    got = kb.keybias_attention(q, k, v, bias)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, kb.keybias_attention_reference(q, k, v, bias))
    assert_closer(f"K1 plain bf16, f32 key bias {F32_BIAS_CASES[case]}", got, *refs[case])


@pytest.mark.parametrize("qdt,bdt", [(torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)],
                         ids=["f32-f32bias", "f32-bf16bias", "bf16-f32bias", "bf16-bf16bias"])
def test_wrapper_contract_on_cpu(qdt, bdt):
    """Every head dim from 1 to 128 and a key bias of either dtype beside q
    of either dtype; above 128 and at float16 the wrapper raises."""
    rng = np.random.default_rng(12)
    bias = torch.from_numpy(np.where(rng.random((2, 6)) < 0.3, -1e9, 0.0).astype(np.float32))
    bias = bias.to(bdt)
    for d in range(1, 129):
        q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, n, d)).astype(np.float32)).to(qdt)
                   for n in (5, 6, 6))
        got = kb.keybias_attention(q, k, v, bias)
        assert got.shape == (2, 3, 5, d) and got.dtype == qdt
        assert torch.equal(got, kb.keybias_attention_reference(q, k, v, bias))
    wide_q, wide_kv = torch.zeros(2, 3, 5, 129, dtype=qdt), torch.zeros(2, 3, 6, 129, dtype=qdt)
    with pytest.raises(ValueError, match="above 128"):
        kb.keybias_attention(wide_q, wide_kv, wide_kv, bias)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kb.keybias_attention(q.half(), k.half(), v.half(), bias)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kb.keybias_attention(q, k, v, bias.half())
