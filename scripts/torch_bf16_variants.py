#!/usr/bin/env python3
"""The design choices of K1's bfloat16 kernel, measured: variants of
avi_talking_tpu_torch/csrc/keybias_attention_bf16.cu timed against it on
the card.

    python scripts/torch_bf16_variants.py [variant,variant,...]

``kernel`` is the source as it is. ``rows16`` .. ``rows64`` fix the query
rows of a block at 16 to 64 (1 to 4 row groups; ``pick_groups`` chooses
otherwise, and above d = 64 takes at most 2), ``producers1`` and
``producers2`` issue the copies from one or two warps instead of four,
``streamed`` streams K and V through the ring at every shape, ``no_rot``
starts every block on tile 0. These compute the same function and are held
to the plain version by ``kb.bf16_disagreement``. The ablations drop one
part of the work and give wrong results, so their time says what that part
costs: ``null`` (the kernel returns at once), ``no_copy`` (no K / V / q
copies), ``no_pass1`` (no products in pass 1), ``no_bias`` (no bias), ``no_pv``
(no P . V product). Each variant is built with nvcc into build/variants/ and
timed at chip_smoke.py's bf16 kernel-check shapes (chip_smoke.BF16_CASES and
BF16_STREAMED), in turns, by its device time under torch.profiler; one JSON
line per shape gives, per variant, the device ms and the share of the limit
(the build and timing machinery is scripts/kernel_variants.py).
"""

from __future__ import annotations

import ctypes
import json
import sys

import kernel_variants

PICK = "  const int groups = pick_groups<D>(B, H, T, S, sms);"
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
    "streamed": [("  const bool resident = plan<D>(S, groups, true).bytes <= (size_t)SMEM_MAX;\n"
                  "  const long long blocks",
                  "  const bool resident = false;\n  const long long blocks")],
    "no_rot": [("  const int rot = qt % tiles;", "  const int rot = 0;")],
    # ablations
    "null": [(START, "  if (S > 0) return;\n" + START)],
    "no_copy": [(COPY, "if (n < 0) " + COPY)],
    "no_pass1": [("    if (key0 < S) {\n      const int slot",
                  "    if (key0 < 0) {\n      const int slot")],
    "no_bias": [("      const float2 b = *reinterpret_cast<const float2*>(br.bias_s + key);",
                 "      const float2 b = make_float2(0.f, 0.f);")],
    "no_pv": [("        mma_bf16(acc[n], p, bv[0], bv[1]);\n"
               "        mma_bf16(acc[n + 1], p, bv[2], bv[3]);",
               "        acc[n][0] += __uint_as_float(p[0] ^ bv[0] ^ bv[1]);\n"
               "        acc[n + 1][0] += __uint_as_float(p[1] ^ bv[2] ^ bv[3]);")],
}


def main() -> int:
    import torch

    cs = kernel_variants.chip_smoke("torch_bf16_variants")
    from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb

    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    fns = kernel_variants.build_variants(
        "keybias_attention_bf16", "avi_keybias_attention_bf16",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p], VARIANTS, names)
    g = torch.Generator(device="cuda").manual_seed(1)
    for case, B, H, T, S, d, lens in cs.BF16_CASES + cs.BF16_STREAMED:
        q, k, v, bias = cs.bf16_inputs(B, H, T, S, d, lens, g)
        ref = kb.keybias_attention_reference(q, k, v, bias)

        def measure(fn):
            out = torch.empty_like(q)

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                         out.data_ptr(), B, H, T, S, d, torch.cuda.current_stream().cuda_stream)
                assert err == 0, err

            call()
            torch.cuda.synchronize()
            dis = kb.bf16_disagreement(out, ref)
            return {"device_ms": cs.device_ms(call, "keybias_attention_bf16_kernel", iters=50),
                    "limit_share": max(dis["worst"], dis["rms_worst"])}

        print(json.dumps({"case": case, "shape": [B, H, T, S, d],
                          **kernel_variants.in_turns(fns, measure)}), flush=True)
    kernel_variants.print_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
