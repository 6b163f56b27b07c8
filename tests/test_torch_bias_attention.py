"""Port parity, kernel K3 (biased attention) and the gradients of K1 and K3.

``fused_bias_attention_reference`` (the plain version) is held to the JAX
Pallas kernel run in interpret mode, as the JAX suite runs it on the CPU;
the wrapper on CPU tensors takes the plain version without launching
anything; the strides through which the CUDA kernel reads a bias are held
to torch's own broadcast. The autograd backward of both wrappers (the
recompute of JAX's ``_keybias_bwd``) is held to ``jax.grad``: K1's to the
custom_vjp of ``keybias_attention(..., interpret=True)``, K3's to the JAX
plain (unfused) attention, bare and inside ``MultiHeadAttention``, to 1e-5
absolute plus 1e-5 relative (gradients reach 20-40 here; the JAX suite's
own gradient check of K1 allows 1e-4 of each). The kernel itself is held
to the plain version on the card by test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.ops.pallas.attention import fused_bias_attention, keybias_attention
from avi_talking_tpu.ops.transformer import MultiHeadAttention as JMHA
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.ops.kernels import bias_attention as kba
from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb
from avi_talking_tpu_torch.ops.transformer import MultiHeadAttention as TMHA

CASES = [
    # B, H, T, S, d, bias shape
    (2, 4, 25, 25, 32, (4, 25, 25)),  # the coefficient model's self-attention
    (2, 4, 25, 25, 32, (25, 25)),  # its cross-attention
    (3, 4, 20, 33, 16, (3, 4, 20, 33)),  # T != S, the vertex model's head width
    (2, 2, 13, 70, 16, (2, 1, 13, 70)),  # rank 4 broadcast over heads, two K tiles
    (1, 3, 9, 9, 32, (1, 1, 9, 9)),  # rank 4 broadcast over batch and heads
    (2, 4, 70, 65, 32, (4, 70, 65)),  # ragged past one 64-query / 64-key tile
]


def _inputs(B, H, T, S, d, bshape, seed=0, masked_row=True):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, T, d)) * d ** -0.5).astype(np.float32)
    k = rng.standard_normal((B, H, S, d)).astype(np.float32)
    v = rng.standard_normal((B, H, S, d)).astype(np.float32)
    bias = rng.standard_normal(bshape).astype(np.float32)
    bias = np.where(rng.random(bshape) < 0.2, np.float32(-1e9), bias)
    if masked_row:
        bias[..., T // 2, :] = -1e9  # a fully masked row: a uniform softmax
    return q, k, v, bias


@pytest.mark.parametrize("B,H,T,S,d,bshape", CASES)
def test_reference_matches_jax_pallas_interpret(B, H, T, S, d, bshape):
    """Plain version vs the JAX kernel in interpret mode: < 1e-5."""
    q, k, v, bias = _inputs(B, H, T, S, d, bshape)
    ref = np.asarray(fused_bias_attention(*map(jnp.asarray, (q, k, v, bias)), interpret=True))
    got = kba.fused_bias_attention_reference(*map(torch.from_numpy, (q, k, v, bias))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    row = got[..., T // 2, :]  # the masked row averages v
    np.testing.assert_allclose(row, np.broadcast_to(v.mean(2), row.shape), atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,H,T,S,d,bshape", CASES)
def test_wrapper_on_cpu_takes_plain_version_without_launch(B, H, T, S, d, bshape):
    q, k, v, bias = map(torch.from_numpy, _inputs(B, H, T, S, d, bshape, seed=1))
    kba.launches = 0
    got = kba.fused_bias_attention(q, k, v, bias)
    assert kba.launches == 0
    torch.testing.assert_close(got, kba.fused_bias_attention_reference(q, k, v, bias),
                               atol=0, rtol=0)


@pytest.mark.parametrize("B,H,T,S,d,bshape", CASES)
def test_bias_strides_read_the_broadcast(B, H, T, S, d, bshape):
    """The kernel's (b, h, t, s) strides over the bias as stored address
    exactly torch's broadcast of it to (B, H, T, S)."""
    bias = torch.from_numpy(_inputs(B, H, T, S, d, bshape)[3])
    strides = kba.bias_strides(bias, B, H, T, S)
    view = torch.as_strided(bias, (B, H, T, S), strides)
    assert torch.equal(view, bias.expand(B, H, T, S))
    assert strides[3] == 1 and (bias.dim() > 2 or strides[:2] == (0, 0))


def test_bias_strides_refuse_what_does_not_broadcast():
    with pytest.raises(ValueError):
        kba.bias_strides(torch.zeros(3, 5, 5), 1, 4, 5, 5)
    with pytest.raises(ValueError):
        kba.bias_strides(torch.zeros(5), 1, 1, 5, 5)
    with pytest.raises(ValueError):
        kba.bias_strides(torch.zeros(1, 1, 1, 5, 5), 1, 1, 5, 5)


def _grads_torch(fn, arrays, cot, bias_grad=True):
    ts = [torch.from_numpy(a).requires_grad_(i < 3 or bias_grad) for i, a in enumerate(arrays)]
    (fn(*ts) * torch.from_numpy(cot)).sum().backward()
    return [None if t.grad is None else t.grad.numpy() for t in ts]


def _plain_jax(q, k, v, bias):
    """The JAX MultiHeadAttention's unfused path, after the projections."""
    logits = jnp.einsum("bhtd,bhsd->bhts", q, k, preferred_element_type=jnp.float32) + bias
    return jnp.einsum("bhts,bhsd->bhtd", jax.nn.softmax(logits, axis=-1), v)


@pytest.mark.parametrize("B,H,T,S,d,bshape", CASES)
def test_bias_attention_gradients_match_jax(B, H, T, S, d, bshape):
    """dq, dk, dv and the bias gradient reduced to the bias's own shape, vs
    jax.grad of the plain attention."""
    arrays = _inputs(B, H, T, S, d, bshape, seed=2, masked_row=False)
    cot = np.random.default_rng(3).standard_normal((B, H, T, d)).astype(np.float32)
    ref = jax.grad(lambda *a: jnp.sum(_plain_jax(*a) * cot), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, arrays))
    got = _grads_torch(kba.fused_bias_attention, arrays, cot)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-5, rtol=1e-5, err_msg=name)
    assert _grads_torch(kba.fused_bias_attention, arrays, cot, bias_grad=False)[3] is None


KB_CASES = [
    # B, H, T, S, d, valid key lengths per batch
    (2, 4, 24, 24, 16, (24, 10)),
    (2, 2, 16, 40, 8, (40, 5)),
    (16, 12, 25, 25, 64, (25,) * 16),  # the training step's shape
]


@pytest.mark.parametrize("B,H,T,S,d,lens", KB_CASES)
def test_keybias_attention_gradients_match_jax_custom_vjp(B, H, T, S, d, lens):
    """K1's autograd backward vs jax.grad through the JAX custom_vjp of
    keybias_attention (interpret mode): dq, dk, dv and d(key_bias)."""
    rng = np.random.default_rng(4)
    q = (rng.standard_normal((B, H, T, d)) * d ** -0.5).astype(np.float32)
    k = rng.standard_normal((B, H, S, d)).astype(np.float32)
    v = rng.standard_normal((B, H, S, d)).astype(np.float32)
    kbias = np.where(np.arange(S)[None] < np.asarray(lens)[:, None], 0.0, -1e9).astype(np.float32)
    kbias = kbias + (rng.standard_normal((B, S)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((B, H, T, d)).astype(np.float32)
    ref = jax.grad(lambda *a: jnp.sum(keybias_attention(*a, True) * cot), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, kbias)))
    got = _grads_torch(kb.keybias_attention, (q, k, v, kbias), cot)
    for name, g, r in zip(("dq", "dk", "dv", "dkey_bias"), got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-5, rtol=1e-5, err_msg=name)
    assert _grads_torch(kb.keybias_attention, (q, k, v, kbias), cot, bias_grad=False)[3] is None


@pytest.mark.parametrize("kind", ["self_hts", "self_ts", "cross_ts", "self_none"])
def test_fused_mha_gradients_match_jax_plain_mha(kind):
    """The port's MultiHeadAttention(use_fused_kernel=True), K3 with its
    backward, vs jax.grad of the JAX layer's plain path: the output (< 1e-5),
    the input gradients and every parameter gradient."""
    B, T, S, D, H = 2, 10, 10 if kind.startswith("self") else 14, 32, 4
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mem = rng.standard_normal((B, S, D)).astype(np.float32)
    bias = {"self_hts": rng.standard_normal((H, T, S)), "self_ts": rng.standard_normal((T, S)),
            "cross_ts": np.where(rng.random((T, S)) < 0.5, -1e9, 0.0),
            "self_none": None}[kind]
    bias = None if bias is None else bias.astype(np.float32)
    cot = rng.standard_normal((B, T, D)).astype(np.float32)
    jm = JMHA(D, H)
    params = jm.init(jax.random.PRNGKey(0), x, x, x)
    params = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
                          jax.tree.map(np.asarray, params))

    def jloss(p, x, mem):
        kv = x if kind.startswith("self") else mem
        out = jm.apply(p, x, kv, kv, bias)
        return jnp.sum(out * cot), out

    (_, jout), (jgp, jgx, jgm) = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(mem))
    p = params["params"]
    tm = random_module(lambda: TMHA(D, H, use_fused_kernel=True), torch.device("cpu"),
                       torch.Generator().manual_seed(0))
    tm.load_state_dict({k: torch.from_numpy(np.array(p[n])) for k, n in (
        ("in_proj_weight", "in_proj_weight"), ("in_proj_bias", "in_proj_bias"),
        ("out_proj.weight", "out_proj_weight"), ("out_proj.bias", "out_proj_bias"))})
    tx, tmem = (torch.from_numpy(a).requires_grad_() for a in (x, mem))
    kv = tx if kind.startswith("self") else tmem
    tout = tm(tx, kv, kv, None if bias is None else torch.from_numpy(bias))
    (tout * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5, rtol=1e-5)
    if not kind.startswith("self"):
        np.testing.assert_allclose(tmem.grad.numpy(), np.asarray(jgm), atol=1e-5, rtol=1e-5)
    jg = jgp["params"]
    for k, n in (("in_proj_weight", "in_proj_weight"), ("in_proj_bias", "in_proj_bias"),
                 ("out_proj.weight", "out_proj_weight"), ("out_proj.bias", "out_proj_bias")):
        np.testing.assert_allclose(tm.get_parameter(k).grad.numpy(), np.asarray(jg[n]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits): to nearest on the low
    13 of fp32's 23 mantissa bits, ties away from zero, as the kernel's
    ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel forms it on tensor cores: each operand split
    into big = tf32(x) and small = tf32(x - big), the product
    small·big + big·small + big·big with fp32 accumulation (each TF32 x TF32
    product is exact in fp32)."""
    ab, bb = _tf32(a), _tf32(b)
    asm, bsm = _tf32(a - ab), _tf32(b - bb)
    return (asm @ bb + ab @ bsm) + ab @ bb


def _matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in one TF32 pass: both operands rounded to TF32."""
    return _tf32(a) @ _tf32(b)


def _attention(q, k, v, bias, matmul=torch.matmul):
    s = matmul(q, k.transpose(-1, -2)) + bias
    return matmul(torch.softmax(s, dim=-1), v)


PRECISION_CASES = [
    # name, B, H, T, S, d, bias: valid key lengths (K1) or "HTT" / "TS" (K3);
    # chip_smoke.py's kernel_check shapes
    ("keybias_generate", 1, 12, 200, 200, 64, (200,)),
    ("keybias_batch_512", 2, 12, 512, 512, 64, (512, 300)),
    ("keybias_ragged_333", 1, 12, 333, 333, 64, (333,)),
    ("keybias_faceformer_600", 1, 12, 600, 600, 64, (600,)),
    ("bias_train_self_HTT", 16, 4, 25, 25, 32, "HTT"),
    ("bias_forward_self_HTT", 1, 4, 600, 600, 32, "HTT"),
    ("bias_forward_cross_TS", 1, 4, 600, 600, 32, "TS"),
    ("bias_vert_self_HTT_d16", 1, 4, 600, 600, 16, "HTT"),
]


@pytest.mark.parametrize("name,B,H,T,S,d,bias_kind", PRECISION_CASES)
def test_3xtf32_keeps_fp32_accuracy_and_one_pass_tf32_does_not(name, B, H, T, S, d, bias_kind):
    """The kernel's precision choice, emulated in plain torch on the CPU:
    attention from 3xTF32 products stays within 1e-5 of the fp64 result (the
    kernel's gate against its plain version), attention from one-pass TF32
    products does not."""
    from avi_talking_tpu_torch.ops.positional import enc_dec_alignment_bias, faceformer_bias

    rng = np.random.default_rng(8)
    q = torch.from_numpy((rng.standard_normal((B, H, T, d)) * d ** -0.5).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, H, S, d)).astype(np.float32))
            for _ in range(2))
    if bias_kind == "HTT":
        bias = faceformer_bias(H, T, 25)
    elif bias_kind == "TS":
        bias = enc_dec_alignment_bias(T, S)
    else:
        lens = torch.tensor(bias_kind)
        bias = torch.where(torch.arange(S)[None] < lens[:, None], 0.0, -1e9)[:, None, None, :]
    ref = _attention(*(t.double() for t in (q, k, v, bias)))
    err3 = float((_attention(q, k, v, bias, _matmul_3xtf32).double() - ref).abs().max())
    err1 = float((_attention(q, k, v, bias, _matmul_tf32).double() - ref).abs().max())
    assert err3 < 1e-5, f"{name}: 3xTF32 off the fp64 result by {err3}"
    assert err1 >= 1e-5, f"{name}: one-pass TF32 within {err1} of the fp64 result"


def test_fused_and_plain_mha_agree():
    """use_fused_kernel only changes the route: the same layer with the flag
    on and off agrees (< 1e-6) on self- and cross-attention."""
    rng = np.random.default_rng(6)
    x, mem = (torch.from_numpy(rng.standard_normal((2, n, 32)).astype(np.float32))
              for n in (9, 13))
    bias = torch.from_numpy(rng.standard_normal((4, 9, 9)).astype(np.float32))
    fused = random_module(lambda: TMHA(32, 4, use_fused_kernel=True), torch.device("cpu"),
                          torch.Generator().manual_seed(1))
    plain = TMHA(32, 4)
    plain.load_state_dict(fused.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(fused(x, x, x, bias), plain(x, x, x, bias), atol=1e-6, rtol=0)
        torch.testing.assert_close(fused(x, mem, mem), plain(x, mem, mem), atol=1e-6, rtol=0)
