"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped without a card (a CUDA kernel has no CPU mode).
The file imports neither JAX nor the JAX package, so it also runs on a
machine with a card and no JAX, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from avi_talking_tpu_torch.ops.kernels import bias_attention as kba
from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb
from avi_talking_tpu_torch.ops.kernels import rasterize as kras

CASES = [
    # B, H, T, S, d, valid key lengths per batch
    (3, 4, 24, 24, 8, (8, 16, 24)),  # distinct per-batch masks
    (2, 2, 16, 40, 16, (40, 5)),  # T != S
    (2, 3, 13, 13, 8, (13, 6)),  # T not a multiple of 8
    (1, 12, 200, 200, 64, (200,)),  # generate's shape
    (2, 12, 512, 512, 64, (512, 300)),  # largest length bucket
    (1, 2, 70, 130, 128, (97,)),  # widest head taken
    # the edges of the 16-query x (4 warps x 16 keys) partition
    (2, 3, 1, 40, 64, (40, 33)),  # T=1: one query row, 15 idle rows
    (1, 4, 17, 50, 32, (50,)),  # T=17: a ragged last query tile of one row
    (2, 2, 12, 1, 16, (1, 1)),  # S=1: three warps see no key
    (2, 2, 9, 5, 64, (5, 3)),  # S=5: fewer keys than warps
    (2, 2, 20, 20, 16, (20, 0)),  # batch 1: every key bias -1e9, uniform rows
    (2, 3, 30, 45, 8, (45, 20)),  # d=8, the narrowest head
    (1, 2, 40, 70, 128, (70,)),  # d=128 with T, S not multiples of 16
    (1, 12, 600, 600, 64, (600,)),  # the FaceFormer encoder's shape
    (8, 12, 64, 64, 64, (64,) * 8),  # train-emote's step (B=8, 64 frames after the resample)
    (8, 6, 64, 64, 64, (64,) * 8),  # the same step on a tp=2 rank: its 6 heads
    (1, 12, 399, 399, 64, (399,)),  # wav2vec2 on 8 s with resample=False (50 fps)
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
    for b, n in enumerate(lens):
        if n == 0:  # a batch whose every key is masked averages v
            torch.testing.assert_close(got[b], v[b].mean(1, keepdim=True).expand_as(got[b]),
                                       atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_kernel_takes_k_and_v_off_a_16_byte_boundary():
    """K and V views that start 4 bytes into their storage (the kernel
    copies them 16 bytes at a time): the wrappers copy them first."""
    q, k, v, bias = _cuda_inputs(1, 2, 20, 24, 16, (24,))
    ks, vs = (torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape) for t in (k, v))
    assert ks.data_ptr() % 16 and vs.data_ptr() % 16 and ks.is_contiguous()
    torch.testing.assert_close(kb.keybias_attention(q, ks, vs, bias),
                               kb.keybias_attention_reference(q, k, v, bias), atol=1e-5, rtol=0)
    b3 = torch.zeros(2, 20, 24, device="cuda")
    torch.testing.assert_close(kba.fused_bias_attention(q, ks, vs, b3),
                               kba.fused_bias_attention_reference(q, k, v, b3), atol=1e-5, rtol=0)


def _grads(fn, inputs, cot):
    ts = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*ts)
    (out * cot).sum().backward()
    return out.detach(), [t.grad for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,S,d,lens", [CASES[0], CASES[1], (16, 12, 25, 25, 64, (25,) * 16),
                                            (8, 12, 64, 64, 64, (64,) * 8),
                                            (8, 6, 64, 64, 64, (64,) * 8)])
def test_keybias_kernel_gradients_match_plain_version(B, H, T, S, d, lens):
    """The kernel forward with the autograd backward vs autograd through the
    plain version: output < 1e-5, dq, dk, dv and d(key_bias) < 1e-4."""
    inputs = _cuda_inputs(B, H, T, S, d, lens)
    cot = torch.randn(B, H, T, d, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    before = kb.launches
    out, grads = _grads(kb.keybias_attention, inputs, cot)
    torch.cuda.synchronize()
    assert kb.launches == before + 1  # the backward launches no kernel
    ref_out, ref_grads = _grads(kb.keybias_attention_reference, inputs, cot)
    torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=0)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_keybias_kernel_refuses_what_it_does_not_take():
    q, k, v, bias = _cuda_inputs(1, 2, 16, 16, 16, (16,))
    with pytest.raises(TypeError):
        kb.keybias_attention(q.half(), k.half(), v.half(), bias.half())
    with pytest.raises(ValueError):  # head_dim not a multiple of 8
        kb.keybias_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                             v[..., :12].contiguous(), bias)
    with pytest.raises(ValueError):  # not contiguous
        kb.keybias_attention(q.transpose(2, 3), k, v, bias)


BF16_CASES = [
    # B, H, T, S, d, valid key lengths per batch; d a multiple of 16
    (3, 4, 24, 24, 16, (8, 16, 24)),
    (1, 12, 200, 200, 64, (200,)),  # generate's shape
    (2, 12, 512, 512, 64, (512, 300)),  # largest length bucket
    (1, 12, 333, 333, 64, (333,)),  # a ragged 64-query tile
    (1, 2, 70, 130, 128, (97,)),  # widest head taken, S past a 64-key tile
    (2, 3, 1, 40, 48, (40, 33)),  # T=1
    (2, 2, 12, 1, 32, (1, 1)),  # S=1
    (2, 2, 20, 20, 16, (20, 0)),  # batch 1: every key bias -1e9, uniform rows
    (1, 12, 600, 600, 64, (600,)),  # the FaceFormer encoder's shape
    # the edges of the key-split partition: 16-key chunks dealt to 4 warps,
    # blocks of 1 to 4 groups of 16 query rows (pick_groups), K and V
    # resident in shared memory or streamed through rings of 64-key tiles
    # where they do not fit; the shapes above take 1 group (T=200, 333), 3
    # (B=2 T=512) and 4 (T=600)
    (1, 3, 40, 65, 64, (65,)),  # S past one tile by one key: warps 1-3 idle on tile 1
    (2, 2, 50, 130, 32, (130, 77)),  # S=130: a 2-key last chunk
    (1, 4, 17, 100, 64, (100,)),  # T=17: a 1-row last query tile
    (1, 6, 700, 700, 64, (700,)),  # 2 row groups at d=64, a 28-row last block
    (2, 12, 256, 256, 128, (256, 100)),  # 32 rows as 2 row groups at d=128
    (1, 2, 64, 600, 128, (600,)),  # streamed: d=128 past the fit
    (1, 2, 64, 1024, 64, (1024,)),  # streamed: d=64 at S=1024
    (2, 2, 40, 700, 128, (700, 0)),  # streamed, batch 1 every key masked
    (2, 12, 512, 600, 128, (600, 321)),  # streamed, 2 row groups a block
    (2, 12, 333, 800, 64, (800, 555)),  # streamed, 2 row groups, a 13-row last block
]


def bf16_within_limit(got, ref, rms=True):
    """The bfloat16 kernel against its plain version, by the limit that
    ``kb.bf16_disagreement`` derives: each element within 2^-7 |ref| +
    2^-9 max|ref|, and the rms within 2^-11 rms(ref) and one element's step."""
    dis = kb.bf16_disagreement(got, ref)
    assert dis["worst"] <= 1.0, dis
    if rms:
        assert dis["rms_worst"] <= 1.0, dis


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,S,d,lens", BF16_CASES)
def test_keybias_bf16_kernel_matches_plain_version(B, H, T, S, d, lens):
    """bfloat16 q, k, v and key bias: the bfloat16 entry, one bf16 launch
    and no fp32 one counted, a bfloat16 output within bf16_within_limit."""
    q, k, v, bias = (t.bfloat16() for t in _cuda_inputs(B, H, T, S, d, lens))
    before, before16 = kb.launches, kb.launches_bf16
    got = kb.keybias_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert (kb.launches, kb.launches_bf16) == (before, before16 + 1)
    assert got.dtype == torch.bfloat16
    ref = kb.keybias_attention_reference(q, k, v, bias)
    bf16_within_limit(got, ref)
    for b, n in enumerate(lens):
        if n == 0:  # a batch whose every key is masked averages v (P = bf16(1/S) on both sides)
            mean = v[b].float().mean(1, keepdim=True).expand(got[b].shape)
            bf16_within_limit(got[b], mean, rms=False)


@pytest.mark.cuda
def test_keybias_bf16_kernel_refuses_what_it_does_not_take():
    q, k, v, bias = (t.bfloat16() for t in _cuda_inputs(1, 2, 16, 16, 24, (16,)))
    with pytest.raises(ValueError):  # head_dim 24: a multiple of 8, not of 16
        kb.keybias_attention(q, k, v, bias)
    q, k, v, bias = (t.bfloat16() for t in _cuda_inputs(1, 2, 16, 16, 32, (16,)))
    with pytest.raises(TypeError):  # mixed dtypes
        kb.keybias_attention(q, k, v, bias.float())


BIAS_CASES = [
    # B, H, T, S, d, bias shape, bias layout ("keys last": as stored;
    # "keys first": stored as (B, H, S, T) and read with key stride T)
    (16, 4, 25, 25, 32, (4, 25, 25), "keys last"),  # the training step's self-attention
    (1, 4, 600, 600, 32, (4, 600, 600), "keys last"),  # predict-length self-attention
    (1, 4, 600, 600, 32, (600, 600), "keys last"),  # its cross-attention
    (1, 4, 600, 600, 16, (4, 600, 600), "keys last"),  # the vertex model's head width
    (2, 3, 70, 130, 8, (2, 3, 70, 130), "keys last"),  # full rank 4, T != S, ragged tiles
    (3, 2, 33, 17, 128, (3, 1, 33, 17), "keys last"),  # broadcast over heads, widest head
    # the edges of the 16-query x (4 warps x 16 keys) partition
    (2, 2, 1, 30, 32, (2, 1, 30), "keys last"),  # T=1
    (1, 3, 17, 40, 16, (3, 17, 40), "keys last"),  # T=17: a ragged last query tile
    (2, 2, 6, 1, 32, (6, 1), "keys last"),  # S=1: three warps see no key
    (1, 4, 12, 5, 64, (4, 12, 5), "keys last"),  # S=5
    (2, 2, 24, 36, 8, (2, 2, 24, 36), "keys last"),  # d=8
    (1, 2, 50, 90, 128, (2, 50, 90), "keys last"),  # d=128
    (2, 3, 40, 70, 32, (2, 3, 40, 70), "keys first"),  # non-unit key stride
]


def _bias_inputs(B, H, T, S, d, bshape, seed=4):
    """Random q, k, v and a bias with scattered -1e9 entries and one fully
    masked row, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, T, d)) * d ** -0.5).astype(np.float32)
    k = rng.standard_normal((B, H, S, d)).astype(np.float32)
    v = rng.standard_normal((B, H, S, d)).astype(np.float32)
    bias = rng.standard_normal(bshape).astype(np.float32)
    bias = np.where(rng.random(bshape) < 0.2, np.float32(-1e9), bias)
    bias[..., T // 2, :] = -1e9
    return [torch.from_numpy(a).cuda() for a in (q, k, v, bias)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,S,d,bshape,layout", BIAS_CASES)
def test_bias_kernel_matches_plain_version(B, H, T, S, d, bshape, layout):
    """fp32 kernel vs plain version, the bias read through its strides:
    < 1e-5; one launch counted; the fully masked row is uniform. A
    "keys first" bias is stored (B, H, S, T) and launched with the strides
    of its (B, H, T, S) transpose, key stride T."""
    q, k, v, bias = _bias_inputs(B, H, T, S, d, bshape)
    before = kba.launches
    if layout == "keys first":
        stored = bias.transpose(2, 3).contiguous()
        view = stored.transpose(2, 3)
        assert view.stride(3) == T
        got = kba._launch(q, k, v, stored, view.stride())
    else:
        got = kba.fused_bias_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert kba.launches == before + 1
    torch.testing.assert_close(got, kba.fused_bias_attention_reference(q, k, v, bias),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(got[..., T // 2, :], v.mean(2), atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,S,d,bshape",
                         [c[:6] for c in (BIAS_CASES[0], BIAS_CASES[4], BIAS_CASES[5])])
def test_bias_kernel_gradients_match_plain_version(B, H, T, S, d, bshape):
    """The kernel forward with the autograd backward vs autograd through the
    plain version: output < 1e-5; dq, dk, dv and the bias gradient < 1e-4."""
    inputs = _bias_inputs(B, H, T, S, d, bshape)
    cot = torch.randn(B, H, T, d, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    before = kba.launches
    out, grads = _grads(kba.fused_bias_attention, inputs, cot)
    torch.cuda.synchronize()
    assert kba.launches == before + 1
    ref_out, ref_grads = _grads(kba.fused_bias_attention_reference, inputs, cot)
    torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=0)
    for g, r in zip(grads, ref_grads):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_bias_kernel_refuses_what_it_does_not_take():
    q, k, v, bias = _bias_inputs(1, 2, 16, 16, 16, (2, 16, 16))
    with pytest.raises(TypeError):
        kba.fused_bias_attention(q.half(), k.half(), v.half(), bias)
    with pytest.raises(TypeError):  # a bias that is not float32
        kba.fused_bias_attention(q, k, v, bias.double())
    with pytest.raises(ValueError):  # not contiguous
        kba.fused_bias_attention(q.transpose(2, 3), k, v, bias)
    with pytest.raises(ValueError):  # a bias that is not contiguous in its own shape
        kba.fused_bias_attention(q, k, v, bias.transpose(1, 2))
    with pytest.raises(ValueError):  # head_dim not a multiple of 8
        kba.fused_bias_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                                 v[..., :12].contiguous(), bias)
    with pytest.raises(ValueError):  # a bias that does not broadcast
        kba.fused_bias_attention(q, k, v, bias[:, :8].contiguous())


@pytest.mark.cuda
def test_decoder_layer_launches_k3_twice():
    """A FaceFormer decoder layer on the card: self- and cross-attention
    each launch K3 once; the output agrees with the same layer on the CPU."""
    from avi_talking_tpu_torch.infra.init import random_module
    from avi_talking_tpu_torch.ops.positional import enc_dec_alignment_bias, faceformer_bias
    from avi_talking_tpu_torch.ops.transformer import TransformerDecoder

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    cpu = random_module(lambda: TransformerDecoder(1, 128, 4, 256), torch.device("cpu"),
                        torch.Generator().manual_seed(0))
    gpu = random_module(lambda: TransformerDecoder(1, 128, 4, 256), torch.device("cuda"),
                        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    x, mem = (torch.from_numpy(rng.standard_normal((2, 60, 128)).astype(np.float32))
              for _ in range(2))
    tb, mb = faceformer_bias(4, 60, 25), enc_dec_alignment_bias(60, 60)
    before = kba.launches
    with torch.no_grad():
        got = gpu(x.cuda(), mem.cuda(), tb.cuda(), mb.cuda())
        torch.cuda.synchronize()
        assert kba.launches == before + 2
        torch.testing.assert_close(got.cpu(), cpu(x, mem, tb, mb), atol=1e-4, rtol=0)


VIS_CASES = [
    # n tiles, cap, px_n, share of valid slots, triangle size
    (3, 100, 37, 0.8, 1.0),  # ragged cap (not a multiple of 256) and px_n
    (2, 600, 1500, 0.7, 1.0),  # several staging steps and pixel passes
    (4, 64, 1024, 0.0, 1.0),  # all-sentinel tiles
    (5, 1024, 3136, 0.3, 0.2),  # the 224^2 / tile 56 shape, small faces
    (1024, 1024, 1024, 1.0, 1.0),  # the render path's launch: 16 frames x 64 tiles
]


def _visibility_inputs(n, cap, px_n, valid_share, size, seed=3):
    """Random tiles with degenerate faces (two equal corners), exact
    duplicates of the previous slot (z ties) and sentinel slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-1.0, 1.0, (n, cap, 1, 3))
    tri = (centre + size * rng.uniform(-1.0, 1.0, (n, cap, 3, 3))).reshape(n, cap, 9)
    tri = tri.astype(np.float32)
    tri[:, ::7, 3:6] = tri[:, ::7, 0:3]
    tri[:, 1::5] = tri[:, 0:-1:5]
    valid = (rng.random((n, cap, 1)) < valid_share).astype(np.float32)
    px = rng.uniform(-1.0, 1.0, (n, px_n)).astype(np.float32)
    py = rng.uniform(-1.0, 1.0, (n, px_n)).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (tri, valid, px, py)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,cap,px_n,valid_share,size", VIS_CASES)
def test_visibility_kernel_bit_equal_to_plain_version(n, cap, px_n, valid_share, size):
    """zbuf and slot bit-equal to the plain version; one launch counted."""
    tri, valid, px, py = _visibility_inputs(n, cap, px_n, valid_share, size)
    before = kras.launches
    z, s = kras.rasterize_tiles_visibility(tri, valid, px, py)
    torch.cuda.synchronize()
    assert kras.launches == before + 1
    rz, rs = kras.rasterize_tiles_visibility_reference(tri, valid, px, py)
    assert s.dtype == torch.int32 and z.dtype == torch.float32
    assert torch.equal(s, rs) and torch.equal(z, rz)
    if valid_share == 0.0:
        assert (s == -1).all() and (z == kras.BIG).all()
    else:
        assert (s >= 0).any()


@pytest.mark.cuda
def test_visibility_kernel_refuses_what_it_does_not_take():
    tri, valid, px, py = _visibility_inputs(2, 64, 32, 0.5, 1.0)
    with pytest.raises(NotImplementedError, match="grad"):
        kras.rasterize_tiles_visibility(tri.clone().requires_grad_(), valid, px, py)
    with pytest.raises(TypeError):
        kras.rasterize_tiles_visibility(tri.double(), valid, px, py)
    with pytest.raises(ValueError):  # not contiguous
        kras.rasterize_tiles_visibility(tri, valid, px.t().contiguous().t(), py)
    with pytest.raises(ValueError):  # shape mismatch
        kras.rasterize_tiles_visibility(tri, valid[:, :32], px, py)


def _hard_visibility_case(case, seed=11):
    """Inputs that probe the kernel's compaction of live slots, its pixel
    blocks and its grid: numpy tri (n, cap, 9), valid (n, cap, 1), px, py."""
    n, cap, px_n, share, size = {
        "head_imbalance": (256, 1024, 1024, 0.3, 0.15),
        "tail_live": (6, 700, 600, 1.0, 0.5),
        "nan_inf_invalid": (6, 600, 1024, 0.5, 0.5),
        "px_n_1": (5, 300, 1, 0.6, 1.0),
        "px_n_7": (5, 300, 7, 0.6, 1.0),
        "px_n_1000": (4, 300, 1000, 0.6, 0.5),
        "px_n_3136": (4, 300, 3136, 0.6, 0.5),
        "cap_1": (9, 1, 200, 1.0, 1.0),
        "cap_257": (5, 257, 700, 0.7, 0.5),
        "tie_255_256": (3, 400, 1024, 0.5, 0.3),
        "tiles_past_grid_y": (65535 + 70, 3, 5, 0.7, 1.0),
    }[case]
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-1.0, 1.0, (n, cap, 1, 3))
    tri = (centre + size * rng.uniform(-1.0, 1.0, (n, cap, 3, 3))).reshape(n, cap, 9)
    tri = tri.astype(np.float32)
    tri[:, ::7, 3:6] = tri[:, ::7, 0:3]  # degenerate
    tri[:, 1::5] = tri[:, 0:-1:5]  # exact duplicates: z ties
    valid = (rng.random((n, cap, 1)) < share).astype(np.float32)
    if case == "head_imbalance":  # most tiles empty, a few at cap
        kind = rng.random(n)
        valid[kind < 0.8] = 0.0
        valid[kind > 0.95] = 1.0
    elif case == "tail_live":  # live slots only at the tail: not a prefix
        valid[:, :cap - 150] = 0.0
    elif case == "nan_inf_invalid":  # poison in the corners of invalid slots
        poison = np.array([np.nan, np.inf, -np.inf], np.float32)[np.arange(n) % 3]
        tri = np.where(valid > 0, tri, poison[:, None, None]).astype(np.float32)
    elif case == "tie_255_256":  # one face over every pixel, twice, across a staging step
        tri[..., 2::3] = np.maximum(tri[..., 2::3], 0.5)  # every other face behind it
        tri[:, 255] = tri[:, 256] = np.float32([-3, -3, 0.25, 3, -3, 0.25, 0, 3, 0.25])
        valid[:, 255] = valid[:, 256] = 1.0
    elif case == "cap_1":  # the one slot covers every pixel in even tiles, is degenerate in odd
        tri[::2, 0] = np.float32([-3, -3, 0.5, 3, -3, 0.5, 0, 3, 0.5])
    px = rng.uniform(-1.0, 1.0, (n, px_n)).astype(np.float32)
    py = rng.uniform(-1.0, 1.0, (n, px_n)).astype(np.float32)
    return tri, valid, px, py


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["head_imbalance", "tail_live", "nan_inf_invalid", "px_n_1",
                                  "px_n_7", "px_n_1000", "px_n_3136", "cap_1", "cap_257",
                                  "tie_255_256", "tiles_past_grid_y"])
def test_visibility_kernel_bit_equal_on_hard_inputs(case):
    """zbuf and slot bit-equal to the plain version where the kernel
    compacts live slots (most tiles empty and a few at cap, live slots only
    at the tail, NaN and inf in invalid slots), where its pixel blocks are
    ragged (px_n 1, 7, 1000, 3136), at cap 1 and 257, at an exact z tie
    between slots 255 and 256, and with more tiles than one grid row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    tri, valid, px, py = (torch.from_numpy(a).cuda() for a in _hard_visibility_case(case))
    before = kras.launches
    z, s = kras.rasterize_tiles_visibility(tri, valid, px, py)
    torch.cuda.synchronize()
    assert kras.launches == before + 1
    rz, rs = kras.rasterize_tiles_visibility_reference(tri, valid, px, py)
    assert torch.equal(s, rs) and torch.equal(z, rz)
    assert (s >= 0).any()
    if case == "tie_255_256":
        assert (s == 255).all()
    if case == "tail_live":
        assert (s[s >= 0] >= tri.shape[1] - 150).all()
    if case == "cap_1":
        assert (s[::2] == 0).all() and (s[1::2] == -1).all()


def _head_ellipsoid(n_lat=72, n_lon=72, frames=2):
    """A closed head ellipsoid in NDC at FLAME density (10368 faces), a few
    frames, each a little smaller and shifted, with per-vertex and
    per-corner attributes."""
    i = np.arange(n_lat + 1)[:, None]
    j = np.arange(n_lon)[None, :]
    th, ph = np.pi * i / n_lat, 2 * np.pi * j / n_lon
    verts = np.stack(np.broadcast_arrays(0.58 * np.sin(th) * np.cos(ph), 0.78 * np.cos(th),
                                         0.5 * np.sin(th) * np.sin(ph) + 0.6), -1).reshape(-1, 3)
    a = (i[:-1] * n_lon + j).reshape(-1)
    b = (i[:-1] * n_lon + (j + 1) % n_lon).reshape(-1)
    faces = np.stack([np.stack([a, b, a + n_lon], -1), np.stack([b, b + n_lon, a + n_lon], -1)],
                     axis=1).reshape(-1, 3).astype(np.int64)
    k = np.arange(frames)[:, None, None]
    verts = (verts[None] * (1.0 - 0.01 * k) + 0.004 * k * np.asarray([1, -1, 0])).astype(np.float32)
    rng = np.random.default_rng(17)
    per_vertex = rng.standard_normal(verts.shape).astype(np.float32)
    per_corner = rng.standard_normal((frames, faces.shape[0], 3, 3)).astype(np.float32)
    return verts, faces, per_vertex, per_corner


def _bfm_size_ndc(frames=2):
    """A closed ellipsoid at BFM09's front-face size (188 x 188: 70,688
    faces) posed as ``viz.bfm.render_bfm`` sees it at 224^2: world radii
    1.0 / 1.25 / 0.8, camera at z = 10, focal 1015; its poles fall outside
    the image, so no 32^2 tile holds more than the cap of 4096 faces."""
    verts, faces, _, _ = _head_ellipsoid(188, 188, frames)
    x, y = verts[..., 0] / 0.58, verts[..., 1] * 1.25 / 0.78
    depth = 10.0 - (verts[..., 2] - 0.6) * 0.8 / 0.5
    ndc = np.stack([2 * (1015 * x / depth + 112) / 224 - 1, 2 * (1015 * y / depth + 112) / 224 - 1,
                    depth], -1).astype(np.float32)
    return torch.from_numpy(ndc).cuda(), torch.from_numpy(faces).cuda()


@pytest.mark.cuda
def test_visibility_kernel_bit_equal_at_cap_4096():
    """K2 at render_bfm's launch: a ~70.7k-face closed mesh at 224^2, tile
    32, cap 4096 (the kernel loops over the cap in staged chunks): bit-equal
    to the plain version, no tile over the cap, one launch."""
    from avi_talking_tpu_torch.viz.rasterizer import _visibility_inputs as binned_inputs
    from avi_talking_tpu_torch.viz.rasterizer import bin_overflow

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    ndc, faces = _bfm_size_ndc()
    assert faces.shape[0] >= 70000
    most, share = bin_overflow(ndc, faces, 224, 224, 32, 4096)
    assert int(most) <= 4096 and float(share) == 0.0
    _, tri, valid, px, py, *_ = binned_inputs(ndc, faces, 224, 224, 32, 4096)
    assert tri.shape[1] == 4096 and int(valid.reshape(valid.shape[0], -1).sum(1).max()) > 1024
    before = kras.launches
    z, s = kras.rasterize_tiles_visibility(tri, valid, px, py)
    torch.cuda.synchronize()
    assert kras.launches == before + 1
    rz, rs = kras.rasterize_tiles_visibility_reference(tri, valid, px, py, chunk=64)
    assert torch.equal(s, rs) and torch.equal(z, rz)
    assert int(s.max()) > 1024  # winners past the old cap of 1024


@pytest.mark.cuda
@pytest.mark.parametrize("per_corner", [False, True])
def test_kernel_route_gradients_match_cpu(per_corner):
    """``rasterize_binned_kernel`` differentiates on the card: K2 decides
    visibility (one launch), autograd runs through the interpolation. On
    the head ellipsoid at 224^2 / tile 56, against the same route on the
    CPU (K2's plain version): masks equal, images and the gradients of
    sum(img^2 * w) in vertices and attributes within 1e-5 of each tensor's
    largest."""
    from avi_talking_tpu_torch.viz.rasterizer import rasterize_binned_kernel

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    verts, faces, pv, pc = _head_ellipsoid()
    attrs = pc if per_corner else pv
    w = np.random.default_rng(18).random((verts.shape[0], 224, 224, 3)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        v = torch.from_numpy(verts).to(dev).requires_grad_()
        a = torch.from_numpy(attrs).to(dev).requires_grad_()
        before = kras.launches
        img, mask = rasterize_binned_kernel(v, torch.from_numpy(faces).to(dev), a, 224, 224,
                                            tile=56, cap=1024, per_corner=per_corner)
        (img ** 2 * torch.from_numpy(w).to(dev)).sum().backward()
        out[dev] = (img.detach().cpu(), mask.cpu(), v.grad.cpu(), a.grad.cpu(),
                    kras.launches - before)
    (ig, mg, vg, ag, n_launch), (ic, mc, vc, ac, _) = out["cuda"], out["cpu"]
    assert n_launch == 1
    assert torch.equal(mg, mc) and bool(mc.any())
    for got, ref in ((ig, ic), (vg, vc), (ag, ac)):
        scale = float(ref.abs().max())
        assert scale > 0
        assert float((got - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_kernel_route_takes_inputs_that_require_grad():
    """Vertices and attributes that require grad go through K2's route on
    the card (one launch) and get finite gradients; K2's own inputs never
    require grad."""
    from avi_talking_tpu_torch.viz.rasterizer import rasterize_binned_kernel

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    verts, faces, pv, _ = _head_ellipsoid(frames=1)
    v = torch.from_numpy(verts).cuda().requires_grad_()
    a = torch.from_numpy(pv).cuda().requires_grad_()
    before = kras.launches
    img, mask = rasterize_binned_kernel(v, torch.from_numpy(faces).cuda(), a, 224, 224, tile=56)
    img.sum().backward()
    assert kras.launches == before + 1 and img.requires_grad and bool(mask.any())
    assert torch.isfinite(v.grad).all() and float(v.grad.abs().max()) > 0
    assert torch.isfinite(a.grad).all() and float(a.grad.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("size", [24, 224, 256])
def test_pixel_centres_match_cpu(size):
    """The rasterizer's pixel centres on the card equal the CPU's bit for
    bit: CUDA divides a tensor by a Python number as a product with its
    reciprocal, which is not correctly rounded, so the grid divides by a
    tensor."""
    from avi_talking_tpu_torch.viz.rasterizer import _pixel_grid

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for got, ref in zip(_pixel_grid(size, size, device="cuda"), _pixel_grid(size, size)):
        assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("bias_kind", ["HTT", "TS"])
def test_bias_kernel_at_the_vertex_decoder_shape(bias_kind):
    """K3 at train-faceformer-vert's decoder (B=4, 4 heads of 16, T=S=100,
    the period-30 self-attention bias or the alignment bias): forward <
    1e-5 and dq, dk, dv < 1e-4 against the plain version, one launch."""
    from avi_talking_tpu_torch.ops.positional import enc_dec_alignment_bias, faceformer_bias

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    B, H, T, d = 4, 4, 100, 16
    g = torch.Generator("cuda").manual_seed(6)
    q = torch.randn(B, H, T, d, device="cuda", generator=g) * d ** -0.5
    k, v = (torch.randn(B, H, T, d, device="cuda", generator=g) for _ in range(2))
    bias = (faceformer_bias(H, T, 30, device="cuda") if bias_kind == "HTT"
            else enc_dec_alignment_bias(T, T, device="cuda"))
    cot = torch.randn(B, H, T, d, device="cuda", generator=g)
    before = kba.launches
    ts = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = kba.fused_bias_attention(*ts, bias)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    assert kba.launches == before + 1
    rs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref = kba.fused_bias_attention_reference(*rs, bias)
    (ref * cot).sum().backward()
    torch.testing.assert_close(out.detach(), ref.detach(), atol=1e-5, rtol=0)
    for t, r in zip(ts, rs):
        torch.testing.assert_close(t.grad, r.grad, atol=1e-4, rtol=0)


def _full_flame():
    from avi_talking_tpu_torch.core.assets import synthetic_assets

    return synthetic_assets(num_vertices=5023, n_shape=100, n_exp=50, num_faces=9976,
                            n_static_landmarks=51)


@pytest.fixture
def no_tf32():
    """fp32 convolutions and matmuls on the card, as the CPU computes them."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_emo_cls_launch_bit_equal_and_its_gradient_route_matches_cpu():
    """The emotion loss's render at train-faceformer-vert's defaults (4
    clips x 100 frames every 20th: 20 frames at 224^2, 16 tiles of 56^2) of
    a synthetic full-size FLAME: K2 bit-equal to its plain version on the
    card; and on 4 of those frames the normal-map render with its gradient
    in the vertices, card against the CPU through the same route: masks
    equal, images and the vertex gradient of sum(img * w) within 1e-5 of
    their largest."""
    from avi_talking_tpu_torch.core.flame import FlameModel
    from avi_talking_tpu_torch.models.fan_encoder import FanEncoder
    from avi_talking_tpu_torch.train.emo_cls import EmoClsHead, EmoClsLoss
    from avi_talking_tpu_torch.viz.rasterizer import (
        compute_vertex_normals, rasterize_binned_kernel, _visibility_inputs)

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    assets = _full_flame()
    exp = torch.from_numpy(np.random.default_rng(3).standard_normal((400, 50)).astype(np.float32))
    verts = FlameModel(assets).vertices_only(torch.zeros(400, 100), exp * 0.5)
    verts = verts.reshape(4, 100, -1)
    emo = EmoClsLoss(faces=assets.faces.cuda(), fan=FanEncoder(224), head=EmoClsHead())
    ndc = emo.ndc(verts.cuda())
    assert ndc.shape[0] == 20
    _, tri, valid, px, py, *_ = _visibility_inputs(ndc, emo.faces, 224, 224, 56, 1024)
    assert tri.shape[:2] == (320, 1024)
    before = kras.launches
    z, s = kras.rasterize_tiles_visibility(tri, valid, px, py)
    torch.cuda.synchronize()
    assert kras.launches == before + 1
    rz, rs = kras.rasterize_tiles_visibility_reference(tri, valid, px, py, chunk=64)
    assert torch.equal(s, rs) and torch.equal(z, rz) and bool((s >= 0).any())

    w = torch.from_numpy(np.random.default_rng(4).random((4, 224, 224, 3)).astype(np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        v = ndc[:4].detach().to(dev).requires_grad_()
        f = assets.faces.to(dev)
        img, mask = rasterize_binned_kernel(v, f, compute_vertex_normals(v, f), 224, 224,
                                            tile=56, cap=1024)
        (img * w.to(dev)).sum().backward()
        out[dev] = (img.detach().cpu(), mask.cpu(), v.grad.cpu())
    (ig, mg, vg), (ic, mc, vc) = out["cuda"], out["cpu"]
    assert torch.equal(mg, mc) and bool(mc.any())
    for got, ref in ((ig, ic), (vg, vc)):
        scale = float(ref.abs().max())
        assert scale > 0 and float((got - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_fan_encoder_card_matches_cpu(no_tf32):
    """FanEncoder at 224^2 (seeded weights, BatchNorm statistics off 0 / 1)
    on the card against the CPU: the four outputs within 1e-4 of their
    largest. The backbone feature's gradient in the image passes 2x2
    max-pools, which route a near-tie's gradient by the last bits of their
    inputs: it is held within 1e-3 of its largest entry and, as a whole,
    1e-4 of its norm; +-1e-7 on the image moves it by 5.5e-3 and 6.6e-4 on
    the CPU alone (``scripts/torch_fan_gradient_noise.py``, PERF.md §6)."""
    from avi_talking_tpu_torch.models.fan_encoder import FanEncoder

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.from_numpy(np.random.default_rng(5).random((2, 3, 224, 224)).astype(np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        m = FanEncoder.random_init(224, seed=1, device=dev)
        with torch.no_grad():
            for name, t in m.named_buffers():
                if name.endswith("running_var"):
                    t.fill_(1.5)
        xi = x.to(dev).requires_grad_()
        heads = m(xi)
        m.backbone_feature(xi).pow(2).sum().backward()
        out[dev] = [h.detach().cpu() for h in heads] + [xi.grad.cpu()]
    for got, ref in zip(out["cuda"][:4], out["cpu"][:4]):
        scale = float(ref.abs().max())
        assert scale > 0 and float((got - ref).abs().max()) <= 1e-4 * scale
    got, ref = out["cuda"][4], out["cpu"][4]
    assert float((got - ref).abs().max()) <= 1e-3 * float(ref.abs().max())
    assert float((got - ref).norm()) <= 1e-4 * float(ref.norm())


@pytest.mark.cuda
def test_fan_conditioner_card_matches_cpu(no_tf32):
    """``FanConditioner.condition`` (train-faceformer --root's conditioning)
    on identical 64^2 crops at B=2, T=6 with the same seed, the FAN on the
    card and on the CPU: the draws equal, ``ref_coeff`` equal, the eye and
    emotion embeddings within 1e-4 of their largest."""
    from avi_talking_tpu_torch.data.train_batches import FanConditioner
    from avi_talking_tpu_torch.models.fan_encoder import FanEncoder

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(6)
    img = (rng.random((2, 6, 64, 64, 3)) * 2 - 1).astype(np.float32)
    coeff = rng.standard_normal((2, 6, 9)).astype(np.float32)
    out, states = {}, {}
    for dev in ("cuda", "cpu"):
        cond = FanConditioner(FanEncoder.random_init(64, seed=1, device=dev), seed=0)
        out[dev] = {k: v.cpu() for k, v in cond.condition(img, coeff).items()}
        states[dev] = cond._rng.bit_generator.state
    assert states["cuda"] == states["cpu"]
    assert torch.equal(out["cuda"]["ref_coeff"], out["cpu"]["ref_coeff"])
    for k in ("eye_embed", "emo_embed"):
        got, ref = out["cuda"][k], out["cpu"][k]
        scale = float(ref.abs().max())
        assert scale > 0 and float((got - ref).abs().max()) <= 1e-4 * scale, k


@pytest.mark.cuda
def test_flame_landmarks_card_match_cpu():
    """A synthetic full-size FLAME with the 68-point tables, global y
    rotations from -60 to 60 degrees (past the contour table's +-39) plus
    random jaws and expressions: the contour rows chosen on the card equal
    the CPU's, and the vertices, 2D / 3D / mediapipe landmarks and the 2D
    landmarks' gradient in the expression (a scatter-add on the card)
    within 1e-5 of their largest."""
    import dataclasses

    from avi_talking_tpu_torch.core.flame import FlameModel

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assets = _full_flame()
    rng = np.random.default_rng(6)
    N = 25
    pose = np.zeros((N, 6), np.float32)
    pose[:, 1] = np.deg2rad(np.linspace(-60, 60, N) + 0.25)  # off the half-degree edges
    pose[:, 3:] = rng.standard_normal((N, 3)) * 0.1
    exp = rng.standard_normal((N, 50)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        flame = dataclasses.replace(FlameModel(assets.to(dev)), with_mediapipe=True)
        e = torch.from_numpy(exp).to(dev).requires_grad_()
        p = torch.from_numpy(pose).to(dev)
        res = flame(torch.zeros(N, 100, device=dev), e, p)
        res[1].pow(2).sum().backward()
        idx, _ = flame._dynamic_landmarks(flame.full_pose(p))
        out[dev] = [r.detach().cpu() for r in res] + [e.grad.cpu(), idx.cpu()]
    assert torch.equal(out["cuda"][-1], out["cpu"][-1])
    assert len(set(out["cpu"][-1][:, 0].tolist())) > 10  # the sweep walks the table
    for got, ref in zip(out["cuda"][:-1], out["cpu"][:-1]):
        scale = float(ref.abs().max())
        assert scale > 0 and float((got - ref).abs().max()) <= 1e-5 * scale
