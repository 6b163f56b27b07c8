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
from avi_talking_tpu_torch.ops.layers import set_compute_dtype
from avi_talking_tpu_torch.ops.kernels import bias_attention as kba
from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb
from avi_talking_tpu_torch.ops.transformer import MultiHeadAttention as TMHA
from test_torch_bf16 import assert_closer, exact_jit
from _torch_threads import one_torch_thread  # noqa: F401

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
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, x, x)
    params = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
                          shapes)

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


# ---- bfloat16, any head dim, either bias dtype ------------------------------

BF16_CASES = [
    # bias kind, d: the decoder's (H, T, T) ALiBi-shaped bias, its (T, S)
    # alignment bias and a full (B, H, T, S) one, all float32 as the
    # FaceFormer family builds them; head dims off both kernels' steps
    (kind, d) for kind in ("HTT", "TS", "BHTS") for d in (8, 24, 33)]


def _bf16_inputs(kind, d, B=2, H=4, T=20, S=20, seed=9):
    """bfloat16 q, k, v (numpy, held as float32 values) and a float32 bias
    with scattered -1e9 entries."""
    rng = np.random.default_rng(seed + d)
    bshape = {"HTT": (H, T, S), "TS": (T, S), "BHTS": (B, H, T, S)}[kind]
    q, k, v = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (
        rng.standard_normal((B, H, T, d)) * d ** -0.5, rng.standard_normal((B, H, S, d)),
        rng.standard_normal((B, H, S, d))))
    bias = np.where(rng.random(bshape) < 0.2, -1e9, rng.standard_normal(bshape))
    return q, k, v, bias.astype(np.float32)


@pytest.fixture(scope="module")
def bf16_refs():
    """JAX's side of every bfloat16 case, computed once: the Pallas kernel
    in interpret mode at bfloat16 and at float32 on the same values, and
    JAX's unfused MultiHeadAttention(dtype=bfloat16) and its float32 run
    for each head dim (one exact_jit compile for all)."""
    kernel_in = [_bf16_inputs(kind, d) for kind, d in BF16_CASES]
    mha_in, mha_params = [], []
    for d in (8, 24, 33):
        rng = np.random.default_rng(d)
        x = np.array(jnp.asarray(rng.standard_normal((2, 11, 4 * d)), jnp.bfloat16)
                     .astype(jnp.float32))
        bias = rng.standard_normal((4, 11, 11)).astype(np.float32)
        shapes = jax.eval_shape(JMHA(4 * d, 4).init, jax.random.PRNGKey(0), x, x, x)
        mha_params.append(jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32), shapes))
        mha_in.append((x, bias))

    def run(kernel_in, mha_in, mha_params):
        bf = jnp.bfloat16
        kernels = [[fused_bias_attention(q.astype(dt), k.astype(dt), v.astype(dt), b,
                                         interpret=True) for dt in (bf, jnp.float32)]
                   for q, k, v, b in kernel_in]
        mhas = [[JMHA(x.shape[-1], 4, dtype=dt).apply(p, x.astype(dt), x.astype(dt),
                                                      x.astype(dt), b)
                 for dt in (bf, jnp.float32)] for (x, b), p in zip(mha_in, mha_params)]
        return kernels, mhas

    kernels, mhas = exact_jit(run, kernel_in, mha_in, mha_params)
    return {"kernel_in": kernel_in, "kernels": kernels, "mha_in": mha_in,
            "mha_params": mha_params, "mhas": mhas}


@pytest.mark.parametrize("case", range(len(BF16_CASES)),
                         ids=[f"{kind}-d{d}" for kind, d in BF16_CASES])
def test_reference_bf16_matches_jax_pallas_interpret(case, bf16_refs):
    """The plain version at bfloat16 q, k, v with a float32 bias (the CUDA
    entry's oracle) against the Pallas kernel in interpret mode, by
    test_torch_bf16's rule; the wrapper on CPU tensors gives the same
    bfloat16 tensor and launches nothing."""
    q, k, v, bias = (torch.from_numpy(a) for a in bf16_refs["kernel_in"][case])
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    kba.launches = kba.launches_bf16 = 0
    got = kba.fused_bias_attention(q, k, v, bias)
    assert got.dtype == torch.bfloat16 and kba.launches == kba.launches_bf16 == 0
    assert torch.equal(got, kba.fused_bias_attention_reference(q, k, v, bias))
    assert_closer(f"K3 plain bf16 {BF16_CASES[case]}", got, *bf16_refs["kernels"][case])


@pytest.mark.parametrize("i,d", list(enumerate((8, 24, 33))))
def test_fused_mha_bf16_matches_jax_unfused(i, d, bf16_refs):
    """MultiHeadAttention(use_fused_kernel=True) at bfloat16 compute (K3's
    plain version on bfloat16 q, k, v beside the float32 bias as stored)
    against JAX's unfused MultiHeadAttention(dtype=bfloat16), which computes
    what ``_attn_kernel`` does, by test_torch_bf16's rule."""
    x, bias = bf16_refs["mha_in"][i]
    p = bf16_refs["mha_params"][i]["params"]
    tm = random_module(lambda: TMHA(4 * d, 4, use_fused_kernel=True), torch.device("cpu"),
                       torch.Generator().manual_seed(0))
    tm.load_state_dict({k: torch.from_numpy(np.array(p[n])) for k, n in (
        ("in_proj_weight", "in_proj_weight"), ("in_proj_bias", "in_proj_bias"),
        ("out_proj.weight", "out_proj_weight"), ("out_proj.bias", "out_proj_bias"))})
    set_compute_dtype(tm, torch.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    with torch.no_grad():
        got = tm(tx, tx, tx, torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    assert_closer(f"fused MHA bf16 d={d}", got, *bf16_refs["mhas"][i])


def test_reference_f32_bit_unchanged():
    """At float32 the plain version computes what it did before P . V was
    accumulated in float32 at every dtype: bit-equal on a fixed case."""
    q, k, v, bias = map(torch.from_numpy, _inputs(2, 4, 25, 25, 32, (4, 25, 25), seed=3))
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) + bias.float()
    before = torch.einsum("bhts,bhsd->bhtd", torch.softmax(scores, dim=-1).to(v.dtype), v)
    assert torch.equal(kba.fused_bias_attention_reference(q, k, v, bias), before.to(q.dtype))


@pytest.mark.parametrize("qdt,bdt", [(torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)],
                         ids=["f32-f32bias", "f32-bf16bias", "bf16-f32bias", "bf16-bf16bias"])
def test_wrapper_contract_on_cpu(qdt, bdt):
    """The inputs the Pallas kernel takes: every head dim from 1 to 128 and
    a bias of either dtype beside q of either dtype, on the CPU as on the
    card; above 128 and at float16 the wrapper raises, naming the limit."""
    rng = np.random.default_rng(11)
    bias = torch.from_numpy(rng.standard_normal((3, 5, 6)).astype(np.float32)).to(bdt)
    for d in range(1, 129):
        q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, n, d)).astype(np.float32)).to(qdt)
                   for n in (5, 6, 6))
        got = kba.fused_bias_attention(q, k, v, bias)
        assert got.shape == (2, 3, 5, d) and got.dtype == qdt
        assert torch.equal(got, kba.fused_bias_attention_reference(q, k, v, bias))
    wide_q, wide_kv = torch.zeros(2, 3, 5, 129, dtype=qdt), torch.zeros(2, 3, 6, 129, dtype=qdt)
    with pytest.raises(ValueError, match="above 128"):
        kba.fused_bias_attention(wide_q, wide_kv, wide_kv, bias)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kba.fused_bias_attention(q.half(), k.half(), v.half(), bias)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kba.fused_bias_attention(q, k, v, bias.half())
