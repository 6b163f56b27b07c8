#!/usr/bin/env python3
"""The design choices of the bfloat16 attention kernel (K1's and K3's
bfloat16 entries), measured: variants of
avi_talking_tpu_torch/csrc/keybias_attention_bf16.cu timed against it on
the card.

    python scripts/torch_bf16_variants.py [variant,variant,...] [--k3-only]

``kernel`` is the source as it is. ``rows16`` .. ``rows64`` fix the query
rows of a block at 16 to 64 (1 to 4 row groups; ``pick_groups`` chooses
otherwise, and above d = 64 takes at most 2), ``producers1`` and
``producers2`` issue the copies from one or two warps instead of four,
``streamed`` streams K, V and the bias through the rings at every shape,
``no_rot`` starts every block on tile 0, ``bias_cp_async`` copies a
bias kept whole tile by tile with K, by cp.async of 16 (or 4) bytes a
lane, instead of as one span (a bulk copy of its aligned middle and
plain loads of its ends) in the set-up, ``lag3`` keeps
three copy groups in flight past the released one instead of two, ``pre0``
issues no copy group before the block's set-up barrier (instead of two). These
compute the same
function and are held to the plain version by ``kb.bf16_disagreement``. The
ablations drop one part of the work and give wrong results, so their time
says what that part costs: ``null`` (the kernel returns at once),
``no_copy`` (no K / V / q copies), ``no_pass1`` (no products in pass 1),
``no_bias`` (no bias added), ``no_pv`` (no P . V product). Each variant is
built with nvcc into build/variants/ and timed, in turns, by its device time
under torch.profiler: K1's key-bias entry at chip_smoke.py's bf16
kernel-check shapes (chip_smoke.BF16_CASES and BF16_STREAMED; skipped with
``--k3-only``) and K3's bias entry at the FaceFormer family's
(chip_smoke.K3_BF16_CASES, the float32 (H, T, T) and (T, S) biases). One
JSON line per shape gives, per variant, the device ms and the share of the
limit (the build and timing machinery is scripts/kernel_variants.py).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import kernel_variants

PICK = "  const int groups = pick_groups<D>(B, H, T, S, staged, sizeof(BT), sms);"
COPY = "cp_async16(dst + r * (D + 8) + 8 * c, src + (size_t)r * D + 8 * c);"
START = "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;"
VARIANTS = {
    "kernel": [],
    "rows16": [(PICK, "  const int groups = 1;")],
    "rows32": [(PICK, "  const int groups = 2;")],
    "rows48": [(PICK, "  const int groups = std::min(3, max_groups<D>());")],
    "rows64": [(PICK, "  const int groups = max_groups<D>();")],
    "producers1": [("constexpr int PRODUCERS = 4;", "constexpr int PRODUCERS = 1;")],
    "producers2": [("constexpr int PRODUCERS = 4;", "constexpr int PRODUCERS = 2;")],
    "streamed": [("    const bool resident = i == 0;", "    const bool resident = false;")],
    "no_rot": [("  const int rot = qt % tiles;", "  const int rot = 0;")],
    "bias_cp_async": [("const bool by_span = !kStaged && resident && ss == 1 && st >= S",
                       "const bool by_span = false && ss == 1 && st >= S")],
    "pre0": [("constexpr int PRE = 2;", "constexpr int PRE = 0;")],
    "lag3": [("constexpr int LAG = 2;", "constexpr int LAG = 3;")],
    # ablations
    "null": [(START, "  if (S > 0) return;\n" + START)],
    "no_copy": [(COPY, "if (n < 0) " + COPY)],
    "no_pass1": [("    if (key0 < S) {\n      const int slot",
                  "    if (key0 < 0) {\n      const int slot")],
    "no_bias": [("      s[j][0] += b.x;\n      s[j][1] += b.y;\n      s[j][2] += b.x;\n"
                 "      s[j][3] += b.y;\n", ""),
                ("      s[j][0] += in0 ? bias_f32(p) : -INFINITY;\n"
                 "      s[j][1] += in1 ? bias_f32(p + 1) : -INFINITY;\n"
                 "      s[j][2] += in0 ? bias_f32(p + off8) : -INFINITY;\n"
                 "      s[j][3] += in1 ? bias_f32(p + off8 + 1) : -INFINITY;\n", "")],
    "no_pv": [("        mma_bf16(acc[n], p, bv[0], bv[1]);\n"
               "        mma_bf16(acc[n + 1], p, bv[2], bv[3]);",
               "        acc[n][0] += __uint_as_float(p[0] ^ bv[0] ^ bv[1]);\n"
               "        acc[n + 1][0] += __uint_as_float(p[1] ^ bv[2] ^ bv[3]);")],
}
SOURCE = "keybias_attention_bf16"
KEY_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
BIAS_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="?", help="comma-separated; all when absent")
    ap.add_argument("--k3-only", action="store_true", help="only K3's shapes")
    args = ap.parse_args()
    import torch

    cs = kernel_variants.chip_smoke("torch_bf16_variants")
    from avi_talking_tpu_torch.ops.kernels import bias_attention as kba
    from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb

    names = args.variants.split(",") if args.variants else list(VARIANTS)
    key_fns = kernel_variants.build_variants(SOURCE, "avi_keybias_attention_bf16", KEY_ARGS,
                                             VARIANTS, names)
    bias_fns = {name: kernel_variants.bind(SOURCE, name, "avi_bias_attention_bf16", BIAS_ARGS)
                for name in names}

    def timer(q, ref, launch):
        """measure(fn) for kernel_variants.in_turns: fn's device ms and its
        share of the limit against ``ref``, ``launch(fn, out)`` calling it."""

        def measure(fn):
            out = torch.empty_like(q)

            def call():
                err = launch(fn, out, torch.cuda.current_stream().cuda_stream)
                assert err == 0, err

            call()
            torch.cuda.synchronize()
            dis = kb.bf16_disagreement(out, ref)
            return {"device_ms": cs.device_ms(call, "keybias_attention_bf16_kernel", iters=50),
                    "limit_share": max(dis["worst"], dis["rms_worst"])}

        return measure

    g = torch.Generator(device="cuda").manual_seed(1)
    for case, B, H, T, S, d, lens in ([] if args.k3_only else cs.BF16_CASES + cs.BF16_STREAMED):
        q, k, v, bias = cs.bf16_inputs(B, H, T, S, d, lens, g)
        measure = timer(q, kb.keybias_attention_reference(q, k, v, bias),
                        lambda fn, out, stream, n=(B, H, T, S, d): fn(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                            out.data_ptr(), *n, stream))
        print(json.dumps({"case": case, "shape": [B, H, T, S, d],
                          **kernel_variants.in_turns(key_fns, measure)}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(13)
    for case, B, H, T, d, kind in cs.K3_BF16_CASES:
        q, k, v, bias = cs.k3_bf16_inputs(B, H, T, d, kind, g)
        strides = kba.bias_strides(bias, B, H, T, T)
        measure = timer(q, kba.fused_bias_attention_reference(q, k, v, bias),
                        lambda fn, out, stream, n=(B, H, T, T, d): fn(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                            out.data_ptr(), *n, *strides, stream))
        print(json.dumps({"case": case, "shape": [B, H, T, T, d], "bias": list(bias.shape),
                          **kernel_variants.in_turns(bias_fns, measure)}), flush=True)
    kernel_variants.print_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
