#!/usr/bin/env python3
"""Where the attention kernel's time goes: variants of
avi_talking_tpu_torch/csrc/bias_attention.cu timed against it on the card.

    python scripts/torch_attention_variants.py [variant,variant,...]

Each variant is the kernel's source with a few named edits (the script
stops if an edit no longer applies to the source): ``cvt`` rounds to TF32
with the cvt.rna instruction instead of integer operations; the ablations
drop one part of the work and give wrong results, so their time says what
that part costs: ``no_bias`` (no bias loads), ``no_split`` (no big / small
splitting, the operands passed as they are), ``no_pv`` (no p . v product),
``no_qk_mma`` (the q . k^T loads and splits without their mma), ``one_pass``
(one TF32 mma per product instead of three), ``no_copy`` (no K / V copies
into shared memory). Every variant is built with nvcc into build/variants/
and timed at chip_smoke.py's K1 and K3 shapes, in turns, by its device time
under torch.profiler; one JSON line per shape gives, per variant, the
device ms and the max |d| against the plain version (the build and timing
machinery is scripts/kernel_variants.py).
"""

from __future__ import annotations

import ctypes
import json
import sys

import kernel_variants

VARIANTS = {
    "kernel": [],
    "cvt": [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
             '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n  return r;')],
    "no_bias": [
        ("bv[j][e] = !ok ? -INFINITY : "
         "(row0 < T ? bias_f32(brow0 + (long long)key * ss) : 0.f);",
         "bv[j][e] = !ok ? -INFINITY : 0.f;"),
        ("bv[j][2 + e] = !ok ? -INFINITY : "
         "(row1 < T ? bias_f32(brow1 + (long long)key * ss) : 0.f);",
         "bv[j][2 + e] = !ok ? -INFINITY : 0.f;")],
    "no_split": [("big = tf32_big(x);\n  small = tf32_big(x - __uint_as_float(big));",
                  "big = __float_as_uint(x);\n  small = big;")],
    "no_pv": [("accumulate16<NT>(p, v_s + 16 * warp * pv, pv, nd, g, t, rs);",
               "rs.acc[0][0] += p[0][0] + p[1][3] + v_s[lane];")],
    "no_qk_mma": [("mma_tf32(sc[j], as, bb0, bb1);\n      mma_tf32(sc[j], ab, bs0, bs1);\n"
                   "      mma_tf32(sb[j], ab, bb0, bb1);",
                   "sc[j][0] += __uint_as_float(bb0 ^ bs1 ^ ab[0] ^ as[1] ^ bb1 ^ bs0 ^ ab[2] "
                   "^ as[3]);")],
    "one_pass": [("mma_tf32(sc[j], as, bb0, bb1);\n      mma_tf32(sc[j], ab, bs0, bs1);\n"
                  "      mma_tf32(sb[j], ab, bb0, bb1);", "mma_tf32(sb[j], ab, bb0, bb1);"),
                 ("mma_tf32(st.acc[n], as, bb0, bb1);\n        mma_tf32(st.acc[n], ab, bs0, bs1);\n"
                  "        mma_tf32(st.acc[n], ab, bb0, bb1);", "mma_tf32(st.acc[n], ab, bb0, bb1);")],
    "no_copy": [("cp_async16(dst + r * pitch + c, src + (ok ? (size_t)(k0 + r) * d + c : 0), ok);",
                 "if (k0 < 0) cp_async16(dst + r * pitch + c, "
                 "src + (ok ? (size_t)(k0 + r) * d + c : 0), ok);")],
}

CASES = [  # chip_smoke.py's kernel_check shapes: name, B, H, T=S, d, bias
    ("generate", 1, 12, 200, 64, "key"), ("batch_512", 2, 12, 512, 64, "key"),
    ("ragged_333", 1, 12, 333, 64, "key"), ("faceformer_600", 1, 12, 600, 64, "key"),
    ("train_self_HTT", 16, 4, 25, 32, "HTT"), ("forward_self_HTT", 1, 4, 600, 32, "HTT"),
    ("forward_cross_TS", 1, 4, 600, 32, "TS"), ("vert_self_HTT_d16", 1, 4, 600, 16, "HTT"),
]


def main() -> int:
    import torch

    cs = kernel_variants.chip_smoke("torch_attention_variants")
    from avi_talking_tpu_torch.ops.kernels import bias_attention as kba
    from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb
    from avi_talking_tpu_torch.ops.positional import enc_dec_alignment_bias, faceformer_bias

    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    fns = kernel_variants.build_variants(
        "bias_attention", "avi_bias_attention_f32",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p],
        VARIANTS, names)
    g = torch.Generator(device="cuda").manual_seed(0)
    for case, B, H, T, d, kind in CASES:
        S = T
        q = torch.randn(B, H, T, d, device="cuda", generator=g) * d ** -0.5
        k = torch.randn(B, H, S, d, device="cuda", generator=g)
        v = torch.randn(B, H, S, d, device="cuda", generator=g)
        if kind == "key":
            lens = torch.tensor([S] + [S * 3 // 5] * (B - 1), device="cuda")
            bias = torch.where(torch.arange(S, device="cuda")[None] < lens[:, None], 0.0, -1e9)
            strides = (S, 0, 0, 1)
            ref = kb.keybias_attention_reference(q, k, v, bias)
        else:
            bias = (faceformer_bias(H, T, 25, device="cuda") if kind == "HTT"
                    else enc_dec_alignment_bias(T, S, device="cuda"))
            strides = kba.bias_strides(bias, B, H, T, S)
            ref = kba.fused_bias_attention_reference(q, k, v, bias)

        def measure(fn):
            out = torch.empty_like(q)

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                         out.data_ptr(), B, H, T, S, d, *strides,
                         torch.cuda.current_stream().cuda_stream)
                assert err == 0, err

            call()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            return {"device_ms": cs.device_ms(call, "bias_attention_kernel", iters=50),
                    "max_abs_err": err}

        print(json.dumps({"case": case, "shape": [B, H, T, S, d],
                          **kernel_variants.in_turns(fns, measure)}), flush=True)
    kernel_variants.print_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
