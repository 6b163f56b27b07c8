#!/usr/bin/env python3
"""Where the visibility kernel's time goes: variants of
avi_talking_tpu_torch/csrc/rasterize_visibility.cu timed against it on the
card.

    python scripts/torch_visibility_variants.py [variant,variant,...]

Each variant is the kernel's source with a few named edits (the script
stops if an edit no longer applies to the source): ``tT_pP`` runs T threads
a block with P pixels each (the pixel block is T * P); ``scalar_records``
reads each face record with eleven 4-byte shared-memory loads instead of
three 16-byte ones; ``unroll2`` unrolls the walk over faces by two;
``prefetch_valid`` loads the next step's ``valid`` before the walk;
``min12`` / ``min16`` ask ptxas for 12 / 16 resident blocks per SM. Every
variant is built with nvcc into build/variants/ and run at chip_smoke.py's
three visibility shapes (chip_smoke.visibility_cases) in turns; one JSON
line per shape gives, per variant, the device ms under torch.profiler and
whether zbuf and slot are bit-equal to the plain version (the build and
timing machinery is scripts/kernel_variants.py).
"""

from __future__ import annotations

import json
import sys

import kernel_variants


def _shape(threads, ppt):
    return [("constexpr int THREADS = 256;", f"constexpr int THREADS = {threads};"),
            ("constexpr int PPT = 1; ", f"constexpr int PPT = {ppt}; ")]


VARIANTS = {
    "kernel": [],
    "t128_p1": _shape(128, 1),
    "t128_p2": _shape(128, 2),
    "t128_p4": _shape(128, 4),
    "t256_p2": _shape(256, 2),
    "t256_p4": _shape(256, 4),
    "t224_p2": _shape(224, 2),
    "t512_p1": _shape(512, 1),
    "t64_p2": _shape(64, 2),
    "t64_p4": _shape(64, 4),
    "t64_p7": _shape(64, 7),
    "scalar_records": [(
        "const float4 e = s_edge[i], b = s_base[i], d = s_depth[i];",
        "const volatile float* ve = &s_edge[i].x;\n"
        "        const volatile float* vb = &s_base[i].x;\n"
        "        const volatile float* vd = &s_depth[i].x;\n"
        "        const float4 e = make_float4(ve[0], ve[1], ve[2], ve[3]);\n"
        "        const float4 b = make_float4(vb[0], vb[1], vb[2], vb[3]);\n"
        "        const float4 d = make_float4(vd[0], vd[1], vd[2], 0.f);")],
    "unroll2": [("      for (int i = 0; i < total; ++i) {",
                 "#pragma unroll 2\n      for (int i = 0; i < total; ++i) {")],
    "prefetch_valid": [(
        "    for (int c0 = 0; c0 < cap; c0 += STAGE) {\n      const int s = c0 + tid;\n"
        "      bool ok = false;\n      float4 edge, base, depth;\n"
        "      if (s < cap && valid_t[s] > 0.f) {",
        "    float v_next = tid < cap ? valid_t[tid] : 0.f;\n"
        "    for (int c0 = 0; c0 < cap; c0 += STAGE) {\n      const int s = c0 + tid;\n"
        "      bool ok = false;\n      float4 edge, base, depth;\n"
        "      const float v = v_next;\n"
        "      v_next = s + STAGE < cap ? valid_t[s + STAGE] : 0.f;\n"
        "      if (s < cap && v > 0.f) {")],
    "min12": [("__launch_bounds__(THREADS)", "__launch_bounds__(THREADS, 12)")],
    "min16": [("__launch_bounds__(THREADS)", "__launch_bounds__(THREADS, 16)")],
}


def main() -> int:
    import torch

    cs = kernel_variants.chip_smoke("torch_visibility_variants")
    from avi_talking_tpu_torch.core.assets import synthetic_assets
    from avi_talking_tpu_torch.ops.kernels import rasterize as kras
    from avi_talking_tpu_torch.ops.kernels.rasterize import _ARGTYPES
    from avi_talking_tpu_torch.pipeline import AviTalkingPipeline, PipelineConfig

    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    fns = kernel_variants.build_variants("rasterize_visibility", "avi_rasterize_visibility_f32",
                                         _ARGTYPES, VARIANTS, names)
    assets = synthetic_assets(num_vertices=5023, n_shape=300, n_exp=50, num_faces=9976)
    pipe = AviTalkingPipeline.random_init(PipelineConfig(), assets, seed=0)
    verts = pipe.generate(cs.synthetic_wav(8.0, seed=1),
                          "A fairly angry man speaks with brow fairly down", seed=0)["vertices"]
    del pipe
    for case, tri, valid, px, py, *_ in cs.visibility_cases(verts, assets.faces.cuda()):
        n, cap, _ = tri.shape
        px_n = px.shape[1]
        rz, rs = kras.rasterize_tiles_visibility_reference(tri, valid, px, py)

        def measure(fn):
            z = torch.empty(n, px_n, device="cuda")
            s = torch.empty(n, px_n, device="cuda", dtype=torch.int32)

            def call():
                err = fn(tri.data_ptr(), valid.data_ptr(), px.data_ptr(), py.data_ptr(),
                         z.data_ptr(), s.data_ptr(), n, cap, px_n,
                         torch.cuda.current_stream().cuda_stream)
                assert err == 0, err

            call()
            torch.cuda.synchronize()
            return {"device_ms": cs.device_ms(call, "rasterize_visibility"),
                    "bit_equal": bool(torch.equal(z, rz) and torch.equal(s, rs))}

        print(json.dumps({"case": case, "shape": [n, cap, px_n],
                          "live_slots_per_tile": cs.live_slot_stats(valid),
                          **kernel_variants.in_turns(fns, measure)}), flush=True)
    kernel_variants.print_card()
    return 0

if __name__ == "__main__":
    sys.exit(main())
