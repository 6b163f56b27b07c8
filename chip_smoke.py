#!/usr/bin/env python3
"""Chip check of the PyTorch / CUDA port (avi_talking_tpu_torch) on one card.

    python3 chip_smoke.py              # the check; needs one CUDA card and nvcc
    python3 chip_smoke.py --profile    # also profiles one generate, one render
                                       # and one FaceFormer, EMOTE, vertex
                                       # FaceFormer and prior training step
                                       # each
    python3 chip_smoke.py --phases train [--profile]
                                       # the build, K1's rows, the gradient
                                       # rows and phases 15-19 alone; its
                                       # result line says "phases": "train"

Run it from the root of a checkout: it builds the port's CUDA kernels from
the checkout's sources into build/, then

1. build:   every kernel of the port (one nvcc per source, all started
            together), reported in seconds with the compiler's register and
            spill report; a spill fails the check;
2. kernels: K1 (key-bias attention) against its plain PyTorch version on the
            card at the generate path's shapes, the FaceFormer encoder's and
            the EMOTE, vertex FaceFormer and FaceFormer training steps',
            and K3 (biased attention) at the FaceFormer decoder's four
            shapes, each with its time (CUDA events around the wrapper, and
            the kernel's own device time under torch.profiler), the plain
            version's, one PyTorch library call's and the card's lower
            bound; K1's and K3's gradients on the card against the same
            formula on CPU copies, and the backward's time at the training
            shapes;
3. generate: full-width PipelineConfig() with seeded random weights and
            full-size synthetic FLAME assets on an 8 s clip: shapes,
            finiteness, same seed -> same output, kernel launches, time;
4. generate_batch: six requests over three length buckets;
5. GPU vs CPU: the same weights and explicit noise through the port on the
            card and on the CPU, as an explicit reference;
6. visibility: K2 (rasterizer visibility) held bit-equal to its plain
            version at three shapes (the render path's launch, a closed
            FLAME-density head mesh at 256^2 / tile 32 and at 224^2 /
            tile 56), with its times (CUDA events and device time), both
            bounds (at the FMA peak, and at the fp32 issue rate its
            rounded arithmetic is held to), the live slots per tile and
            the launch's blocks;
7. render:  the 200 frames of the 8 s clip through FlameVisualizer into a
            video under build/chip_smoke/: K2 launches, repeatability, wall
            time; the kernel route against the dense plain rasterizer on the
            head mesh;
8. render GPU vs CPU: four head-mesh frames through the visualizer on the
            card and on the CPU;
9. serve:   the fixture caption corpus (experiments/) through InferenceServer
            at max_batch 4, driven as `cli serve` drives it, each result held
            to generate_batch on the same padded micro-batch; p50 / p99;
10. kernel_check bf16: K1's bfloat16 entry against its plain version at
            the generate shapes (B=1 H=12 T=S=200, 333, 600; B=2 T=S=512),
            with its times, SDPA's at bfloat16 and the bf16-peak bound;
11. generate_bf16: `--bf16` at full width on the fp32 pipeline's weights:
            K1 bf16 12 launches a generate and fp32 0, finite outputs, the
            distance to the fp32 run on the same weights and noise, the six
            requests, generate's seconds at bf16 and fp32 in turns; then
            `cli serve --bf16` over the fixture corpus;
12. checkpoint: full-width synthetic reference checkpoints (EMOTE, the
            prior's .pth, HF CLIP text) through `import-emote`,
            `import-prior`, `import-clip --weights`; `generate --checkpoint`
            bit-equal to load_state_dict; `convert-flame` on a
            FLAME-2020-shaped pickle, then `--flame-npz --save-video` on it
            with K2's launches;
13. faceformer: full-width FaceFormerConfig() (wav2vec2-base, decoder 128
            wide) on 24 s of audio: the teacher-forced forward and the
            KV-cached predict, with K1 / K3 launches, AR vs teacher-forced
            consistency, the card against the CPU, repeatability and times;
14. train_faceformer: `cli train-faceformer` at its defaults (B=16, T=25)
            for 5 steps, launches per step, step time; one step on the card
            against the same step on the CPU;
15. train_emote: the EMOTE head at full width and `train-emote`'s defaults
            (B=8, 64 frames): the shape K1 sees, K1 launches per step, step
            time; one step card vs CPU; the `train-emote` command for two
            stages of 3 steps with a run directory, and `last` restored;
16. train_emote_neural: EMOTE's neural-loss stage at full width (renders
            at 224^2, the three towers at seeded random init): `train-emote
            --neural` at B=2, 32 frames; one neural step card vs CPU and
            the render and towers on identical vertices; the step's time,
            frames per second, K2 launches and device ms, peak memory; K2
            at the predicted video's launch (2048 tiles) against its plain
            version;
17. train_faceformer_vert: `train-faceformer-vert` at full width
            (FaceFormerVertConfig(), B=4, 100 frames) on a synthetic MEAD
            tree and a synthetic full-size FLAME: synthetic and
            --disentangle runs with checkpoints loaded back; the main path
            `--mead-root --disentangle --emo-cls` with K1, K3 and K2 under
            every step; the emotion head's pretrain round trip; one step
            card vs CPU (B=2, 40 frames) and one `train-faceformer` step
            with the landmark terms; the step's time, launches and peak
            memory; K3 at the decoder's shape forward and backward, K2 at
            the emotion loss's launch;
18. train_prior: the prior trainer at full width (B=256): step time; one
            step card vs CPU with the same draws; `train-prior` for 4 steps
            with validation and checkpoints, then --resume from step 4;
19. train_data: the data-backed commands on a synthetic MEAD tree of 18
            clips x 100 frames with 224^2 crops, at full width and their
            defaults: `train-emote --root` (the split, K1 12 a step, the head
            moved), `train-faceformer --root` with FAN conditioning (K1 12
            and K3 2 a step; the step split into batch reading and PNG
            decoding, the FanConditioner and the training step),
            FanConditioner and one conditioned step card vs CPU, and
            `train-prior --json-dir` / `--root` on the caption corpus with
            featurize card vs CPU (limits in its docstring; the crops are
            unfiltered PNGs, so their decode is a lower bound of a real
            crop's, which the phase also times per row filter);
20. the kernels summary line (K1 at the generate path's, the EMOTE step's,
            the vertex step's and the FaceFormer step's shapes, and its
            bf16 entry at generate --bf16's; K2 at the render path's (under
            the plain and the --flame-npz generate), the neural step's and
            the emotion loss's launches; K3 at the FaceFormer decoder's and
            the vertex decoder's; with the launches of each path that runs
            them) and the card's name and power limit;
21. the result line.

Each phase prints one JSON line. Any failure raises and the script exits
non-zero without the result line. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))

# fp32 vector (non tensor core) peak, memory rate, and the dense TF32 and
# bf16 tensor-core peaks by H100 variant (NVIDIA data sheets, rates without
# sparsity); the SXM part is the default.
PEAKS = {
    "PCIe": (51e12, 2.0e12, 378e12, 756e12),
    "NVL": (60e12, 3.9e12, 417.5e12, 835e12),
    "SXM": (67e12, 3.35e12, 495e12, 989e12),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, PEAKS[key]
    return "SXM", PEAKS["SXM"]


def time_ms(fn, iters: int = 20, reps: int = 7) -> float:
    """Median over ``reps`` of CUDA-event time per call, ``iters`` calls each,
    after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, kernel=None, iters: int = 20):
    """Device time per call of ``fn`` under torch.profiler, over ``iters``
    calls after a warm-up: for each kernel whose name holds ``kernel``
    (every device kernel when None), its mean self device time times its
    launches per call (its count over ``iters``, rounded, at least 1),
    summed. A profiler session now and then loses device events: one that
    saw fewer than ``iters`` launches of a kernel is taken again, three
    times at most, and the means of the last are used. None if no session
    saw such a kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = [(evt.self_device_time_total, evt.count) for evt in prof.key_averages()
                if evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and (kernel is None or kernel in evt.key) and evt.count]
        if not seen:
            continue
        best = sum(t / n * max(1, round(n / iters)) for t, n in seen) / 1e3
        if min(n for _, n in seen) >= iters:
            break
    return best


def attention_bound(B, H, T, S, d, bias_numel, peaks):
    """K1's and K3's least time on this card for the kernel's exact fp32
    arithmetic: 4*B*H*T*S*d operations (q.k^T and p.v), each formed from 3
    TF32 tensor-core products, over the dense TF32 peak; or q, k, v and out
    read or written once and the bias as it is stored (K1: (B, S)) over the
    memory rate, whichever is larger."""
    ops = 3 * 4 * B * H * T * S * d
    nbytes = 4 * B * H * (2 * T + 2 * S) * d + 4 * bias_numel
    t_ops, t_bytes = ops / peaks[2], nbytes / peaks[1]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def attention_backward_bound(B, H, T, S, d, bias_numel, peaks):
    """The recompute backward's least time: five (T, S, d) products (the
    scores, dv, dw, dq, dk), 10*B*H*T*S*d fp32 operations; q, k, v, do and
    the bias read once, dq, dk, dv written once."""
    flops = 10 * B * H * T * S * d
    nbytes = 4 * B * H * (3 * T + 3 * S) * d + 4 * bias_numel
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def visibility_bound(tri, valid, px, py, peaks, chunk=64):
    """K2's least time for these inputs. A (pixel, live slot) pair needs
    evaluating only where the pixel lies in the face's bounding box or the
    face covers it (rounding can cover a pixel just outside the box); such a
    pair costs 15 fp32 operations (two offsets, two edge functions of 4, w2
    of 2, three sign tests), and a covered one 6 more (the depth, 5, and its
    compare). Pairs outside the box cost nothing here, as if culled for
    free. Both counts are this data's. The no-FMA bound takes the same
    count at half the FMA peak: the kernel rounds every product and sum on
    its own (__fmul_rn, __fadd_rn), as bit-equality with the plain version
    needs, so none of them contracts into an FMA, and the fp32 issue rate,
    one operation per lane and cycle, is its ceiling. Bytes: valid, px and
    py read once, the corners of the valid slots alone (no other is
    needed), zbuf and slot written once. ``walked_pairs`` are the pairs of
    a walk over every live slot, as the kernel makes."""
    import torch

    n, cap, _ = tri.shape
    px_n = px.shape[1]
    pairs = covered = walked = 0
    for c0 in range(0, cap, chunk):
        t = tri[:, c0:c0 + chunk]
        x0, y0, x1, y1, x2, y2 = (t[..., i:i + 1] for i in (0, 1, 3, 4, 6, 7))
        denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        ok = (denom.abs() > 1e-12) & (valid[:, c0:c0 + chunk] > 0)
        inv = 1.0 / torch.where(ok, denom, torch.ones_like(denom))
        qx, qy = px[:, None], py[:, None]
        dx, dy = qx - x2, qy - y2
        w0 = ((y1 - y2) * dx + (x2 - x1) * dy) * inv
        w1 = ((y2 - y0) * dx + (x0 - x2) * dy) * inv
        hit = (w0 >= 0) & (w1 >= 0) & (1.0 - w0 - w1 >= 0) & ok
        xs, ys = t[..., 0::3], t[..., 1::3]
        in_box = ((qx >= xs.amin(-1, keepdim=True)) & (qx <= xs.amax(-1, keepdim=True))
                  & (qy >= ys.amin(-1, keepdim=True)) & (qy <= ys.amax(-1, keepdim=True)))
        covered += int(hit.sum())
        pairs += int(((in_box & ok) | hit).sum())
        walked += int(ok.sum()) * px_n
    flops = 15 * pairs + 6 * covered
    nbytes = 4 * n * cap + 4 * 9 * int((valid > 0).sum()) + 4 * n * px_n * 4
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    t_issue = flops / (peaks[0] / 2)
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ms_no_fma": max(t_issue, t_bytes) * 1e3,
            "bound_no_fma_by": "operations" if t_issue >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "pairs": pairs, "covered_pairs": covered,
            "walked_pairs": walked}


def live_slot_stats(valid):
    """Live (valid) slots per tile of K2's input valid (n, cap, 1): mean,
    median, max, the tiles with none and at cap, and all tiles."""
    live = valid.reshape(valid.shape[0], -1).gt(0).sum(1)
    cap = valid.shape[1]
    return {"mean": float(live.float().mean()), "median": float(live.float().median()),
            "max": int(live.max()), "empty_tiles": int((live == 0).sum()),
            "tiles_at_cap": int((live == cap).sum()), "tiles": int(live.numel())}


def visibility_launch(n, px_n, ptxas):
    """K2's launch for n tiles of px_n pixels: the blocks, threads and
    pixels a block that its source's constants give (a block per pixel
    block and tile, at most 65535 tiles a grid row), and from the ptxas
    lines of its build the registers, the static shared memory and the
    blocks resident per SM on Hopper (65536 registers allotted to a warp in
    units of 256, 64 warps, 32 blocks and 233472 bytes of shared memory an
    SM, 1024 of them reserved per block), where this run built it."""
    import re

    from avi_talking_tpu_torch.ops.kernels import build

    with open(os.path.join(build.CSRC_DIR, "rasterize_visibility.cu")) as f:
        src = f.read()
    threads = int(re.search(r"constexpr int THREADS = (\d+);", src)[1])
    block_px = threads * int(re.search(r"constexpr int PPT = (\d+);", src)[1])
    launch = {"blocks": -(-px_n // block_px) * min(n, 65535), "threads": threads,
              "pixels_per_block": block_px}
    info = " ".join(ptxas)
    if m := re.search(r"Used (\d+) registers", info):
        regs, warps = int(m[1]), threads // 32
        smem = int(m[1]) if (m := re.search(r"(\d+) bytes smem", info)) else 0
        launch.update(registers=regs, smem_bytes=smem, blocks_per_sm=min(
            65536 // (math.ceil(regs * 32 / 256) * 256) // warps, 64 // warps, 32,
            233472 // (smem + 1024)))
    return launch


def visibility_cases(verts, faces):
    """K2's inputs at chip_smoke's three shapes: the render path's launch
    (16 frames of ``verts``, 256^2, tile 32, cap 1024), and the head mesh
    (16 frames) at 256^2 / tile 32 and 224^2 / tile 56. -> [(name, tri,
    valid, px, py, frames, faces)]."""
    import torch

    from avi_talking_tpu_torch.viz import FlameVisualizer
    from avi_talking_tpu_torch.viz.rasterizer import _visibility_inputs

    hv, hf = head_mesh()
    head = torch.from_numpy(head_frames(hv, 16)).cuda()
    hf = torch.from_numpy(hf).cuda()
    render_ndc = FlameVisualizer(faces, 256).project(torch.as_tensor(verts[:16]).cuda())
    cases = []
    for name, v, f, size, tile in (("render_256_tile32", render_ndc, faces, 256, 32),
                                   ("head_256_tile32", head, hf, 256, 32),
                                   ("head_224_tile56", head, hf, 224, 56)):
        _, tri, valid, px, py, *_ = _visibility_inputs(v, f.long(), size, size, tile, 1024)
        cases.append((name, tri, valid, px, py, v.shape[0], f.shape[0]))
    return cases


def head_mesh(n_lat: int = 72, n_lon: int = 72):
    """A closed head ellipsoid in NDC at FLAME density (10368 faces at
    72 x 72): front and back faces bin like FLAME's, and its small coherent
    triangles leave most of a tile's 1024 slots as sentinels."""
    import numpy as np

    i = np.arange(n_lat + 1)[:, None]
    j = np.arange(n_lon)[None, :]
    th, ph = np.pi * i / n_lat, 2 * np.pi * j / n_lon
    verts = np.stack(np.broadcast_arrays(0.58 * np.sin(th) * np.cos(ph), 0.78 * np.cos(th),
                                         0.5 * np.sin(th) * np.sin(ph) + 0.6), axis=-1)
    a = (i[:-1] * n_lon + j).reshape(-1)
    b = (i[:-1] * n_lon + (j + 1) % n_lon).reshape(-1)
    faces = np.stack([np.stack([a, b, a + n_lon], -1), np.stack([b, b + n_lon, a + n_lon], -1)],
                     axis=1).reshape(-1, 3)
    return verts.reshape(-1, 3).astype(np.float32), faces.astype(np.int32)


def head_frames(verts, n: int):
    """n frames of the head mesh, each a little smaller and shifted."""
    import numpy as np

    k = np.arange(n, dtype=np.float32)[:, None, None]
    return (verts[None] * (1.0 - 0.01 * k) + np.float32(0.004) * k * np.float32([1, -1, 0])
            ).astype(np.float32)


def synthetic_wav(seconds: float, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    voice = 0.3 * np.sin(2 * np.pi * 180 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (voice + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


def phase_build():
    import torch

    from avi_talking_tpu_torch.ops.kernels import build

    # the reference numbers are full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    names = ["bias_attention", "keybias_attention_bf16", "rasterize_visibility"]
    built = build.build(names)
    for name in names:
        build.load(name)
    ptxas = {name: [line.strip() for line in b["log"].splitlines()
                    if "Used" in line or "spill" in line] for name, b in built.items()}
    for name, lines in ptxas.items():
        spills = [line for line in lines if "spill" in line
                  and not line.endswith("0 bytes spill stores, 0 bytes spill loads")]
        check(not spills, f"csrc/{name}.cu spills registers: {spills}")
    emit({"phase": "build",
          "kernels": {name: {"seconds": b["seconds"], "ptxas": ptxas[name]}
                      for name, b in built.items()},
          "total_s": time.perf_counter() - t0,
          "tf32": "off: torch.backends.cuda.matmul.allow_tf32 = False, "
                  "torch.backends.cudnn.allow_tf32 = False"})
    return ptxas


def phase_kernels(peaks):
    import torch
    import torch.nn.functional as F

    from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb

    tol = 1e-5  # fp32 kernel vs fp32 plain version: only summation order differs
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("generate", 1, 12, 200, 200, 64, (200,)),
        ("batch_512", 2, 12, 512, 512, 64, (512, 300)),
        ("ragged_333", 1, 12, 333, 333, 64, (333,)),
        ("faceformer_600", 1, 12, 600, 600, 64, (600,)),  # the FaceFormer encoder
        ("emote_train", 8, 12, 64, 64, 64, (64,) * 8),  # train-emote's step, after the resample
        ("vert_train", 4, 12, 100, 100, 64, (100,) * 4),  # train-faceformer-vert's step
        ("faceformer_train", 16, 12, 25, 25, 64, (25,) * 16),  # train-faceformer's step
    ]
    rows = []
    for name, B, H, T, S, d, lens in cases:
        q = torch.randn(B, H, T, d, device="cuda", generator=g) * d ** -0.5
        k = torch.randn(B, H, S, d, device="cuda", generator=g)
        v = torch.randn(B, H, S, d, device="cuda", generator=g)
        valid = torch.tensor(lens, device="cuda")
        bias = torch.where(torch.arange(S, device="cuda")[None] < valid[:, None], 0.0, -1e9)
        out = kb.keybias_attention(q, k, v, bias)
        torch.cuda.synchronize()
        ref = kb.keybias_attention_reference(q, k, v, bias)
        err = float((out - ref).abs().max())
        check(math.isfinite(err) and err < tol, f"keybias_attention {name}: max |d| {err} >= {tol}")
        mask = bias[:, None, None, :]

        def kernel():
            return kb.keybias_attention(q, k, v, bias)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)

        row = {
            "case": name, "shape": [B, H, T, S, d], "max_abs_err": err, "tol": tol,
            "ms": time_ms(kernel),
            "device_ms": device_ms(kernel, "bias_attention_kernel"),
            "plain_ms": time_ms(lambda: kb.keybias_attention_reference(q, k, v, bias)),
            "library_ms": time_ms(library),
            "library_device_ms": device_ms(library),
        }
        row["bound_ms"], row["bound_by"], row["tf32_ops"], row["bytes"] = attention_bound(
            B, H, T, S, d, B * S, peaks)
        rows.append(row)
        emit({"phase": "kernel_check", "kernel": "keybias_attention", **row})
    return rows


def bias_attention_row(name, B, H, T, d, kind, period, peaks, g):
    """K3 against its plain version on random q / k / v of (B, H, T, d)
    (S = T) with the decoder's (H, T, T) bias ("HTT", ``period``) or its
    (T, S) alignment bias ("TS"): the error, the wrapper's and the kernel's
    time, the plain version's, scaled_dot_product_attention's, the bound."""
    import torch
    import torch.nn.functional as F

    from avi_talking_tpu_torch.ops.kernels import bias_attention as kba
    from avi_talking_tpu_torch.ops.positional import enc_dec_alignment_bias, faceformer_bias

    tol = 1e-5  # fp32 kernel vs fp32 plain version: only summation order differs
    S = T
    q = torch.randn(B, H, T, d, device="cuda", generator=g) * d ** -0.5
    k = torch.randn(B, H, S, d, device="cuda", generator=g)
    v = torch.randn(B, H, S, d, device="cuda", generator=g)
    bias = (faceformer_bias(H, T, period, device="cuda") if kind == "HTT"
            else enc_dec_alignment_bias(T, S, device="cuda"))
    out = kba.fused_bias_attention(q, k, v, bias)
    torch.cuda.synchronize()
    ref = kba.fused_bias_attention_reference(q, k, v, bias)
    err = float((out - ref).abs().max())
    check(math.isfinite(err) and err < tol, f"fused_bias_attention {name}: max |d| {err} >= {tol}")
    mask = bias[None] if bias.dim() == 3 else bias[None, None]  # a broadcast view, no copy

    def kernel():
        return kba.fused_bias_attention(q, k, v, bias)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)

    row = {
        "case": name, "shape": [B, H, T, S, d], "bias_shape": list(bias.shape),
        "max_abs_err": err, "tol": tol,
        "ms": time_ms(kernel),
        "device_ms": device_ms(kernel, "bias_attention_kernel"),
        "plain_ms": time_ms(lambda: kba.fused_bias_attention_reference(q, k, v, bias)),
        "library_ms": time_ms(library),
        "library_device_ms": device_ms(library),
    }
    row["bound_ms"], row["bound_by"], row["tf32_ops"], row["bytes"] = attention_bound(
        B, H, T, S, d, bias.numel(), peaks)
    emit({"phase": "kernel_check", "kernel": "fused_bias_attention", **row})
    return row


def phase_bias_kernels(peaks):
    """K3 against its plain version at the FaceFormer decoder's shapes: the
    training step's self-attention, and predict-length (600-frame)
    self-attention, cross-attention and the vertex model's head width."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(3)
    cases = [
        ("train_self_HTT", 16, 4, 25, 32, "HTT"),
        ("forward_self_HTT", 1, 4, 600, 32, "HTT"),
        ("forward_cross_TS", 1, 4, 600, 32, "TS"),
        ("vert_self_HTT_d16", 1, 4, 600, 16, "HTT"),
    ]
    return [bias_attention_row(name, B, H, T, d, kind, 25, peaks, g)
            for name, B, H, T, d, kind in cases]


def attention_grad_row(name, B, H, T, d, bias, peaks, g):
    """The gradient of K1 (``name`` "keybias_attention", ``bias`` (B, S)) or
    K3 ("fused_bias_attention", its bias as stored) at (B, H, T, d), S = T:
    the kernel forward with the autograd backward on the card against the
    same wrappers on CPU copies, and the backward's time beside its bound,
    the plain version's backward (autograd through it) and
    scaled_dot_product_attention's backward."""
    import torch
    import torch.nn.functional as F

    from avi_talking_tpu_torch.ops.kernels import bias_attention as kba
    from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb

    tol = 1e-4
    S = T
    q = torch.randn(B, H, T, d, generator=g) * d ** -0.5
    k, v = torch.randn(B, H, S, d, generator=g), torch.randn(B, H, S, d, generator=g)
    cot = torch.randn(B, H, T, d, generator=g)
    if name == "keybias_attention":
        fn, plain, bias4 = kb.keybias_attention, kb.keybias_attention_reference, bias[:, None, None]
    else:
        fn, plain = kba.fused_bias_attention, kba.fused_bias_attention_reference
        bias4 = bias[None] if bias.dim() == 3 else bias[None, None]
    grads = {}
    for dev in ("cpu", "cuda"):
        ts = [t.to(dev, copy=True).requires_grad_(i < 3) for i, t in enumerate((q, k, v, bias))]
        (fn(*ts) * cot.to(dev)).sum().backward()
        grads[dev] = [t.grad.cpu() for t in ts[:3]]
    errs = {n: float((a - b).abs().max()) for n, a, b in zip(("dq", "dk", "dv"), grads["cuda"],
                                                              grads["cpu"])}
    for n, e in errs.items():
        check(e < tol, f"{name} gradient {n} on the card vs the CPU: max |d| {e} >= {tol}")
    qc, kc, vc = (t.cuda().requires_grad_() for t in (q, k, v))
    bc, cc = bias.cuda(), cot.cuda()

    def bwd_ms(out):
        return time_ms(lambda: torch.autograd.grad(out, (qc, kc, vc), cc, retain_graph=True))

    out = fn(qc, kc, vc, bc)
    row = {"kernel": name, "shape": [B, H, T, S, d], "bias_shape": list(bias.shape),
           "max_abs_err": errs, "tol": tol, "backward_ms": bwd_ms(out),
           # every device kernel of the backward, summed
           "backward_device_ms": device_ms(
               lambda: torch.autograd.grad(out, (qc, kc, vc), cc, retain_graph=True)),
           "plain_backward_ms": bwd_ms(plain(qc, kc, vc, bc)),
           "library_backward_ms": bwd_ms(F.scaled_dot_product_attention(
               qc, kc, vc, attn_mask=bias4.cuda(), scale=1.0))}
    row["bound_ms"], row["bound_by"] = attention_backward_bound(B, H, T, S, d, bias.numel(), peaks)
    emit({"phase": "attention_grads", **row})
    return row


def phase_attention_grads(peaks):
    """K1's and K3's gradients at the training steps' shapes (K1: wav2vec2
    after the 50 -> 25 fps resample, B=16 H=12 T=S=25 d=64 in the FaceFormer
    step and B=8 H=12 T=S=64 d=64 in the EMOTE step; K3: the decoder's
    self-attention, B=16 H=4 T=S=25 d=32), by ``attention_grad_row``."""
    import torch

    from avi_talking_tpu_torch.ops.positional import faceformer_bias

    g = torch.Generator().manual_seed(5)
    return [attention_grad_row(name, B, H, T, d, torch.zeros(B, T) if name == "keybias_attention"
                               else faceformer_bias(H, T, 25), peaks, g)
            for name, B, H, T, d in (("keybias_attention", 16, 12, 25, 64),
                                     ("fused_bias_attention", 16, 4, 25, 32),
                                     ("keybias_attention", 8, 12, 64, 64))]


def _fill_output_map(model, seed):
    """Fills a FaceFormer's zero-init output map ``vertice_map_r`` (seeded,
    LeCun scale), so that its outputs carry weight and every weight takes a
    gradient in the first step."""
    import torch

    g = torch.Generator().manual_seed(seed + 1)
    w = model.vertice_map_r.weight
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=g) * w.shape[1] ** -0.5)
    return model


def _faceformer_model(cfg, seed, device):
    """Seeded full-width FaceFormerCoeff with its zero-init head filled
    (``_fill_output_map``); obj_embedding and the vertice_map bias stay 0,
    which aligns the AR and teacher-forced start tokens."""
    from avi_talking_tpu_torch.models.faceformer import FaceFormerCoeff

    return _fill_output_map(FaceFormerCoeff.random_init(cfg, seed=seed, device=device), seed)


def _faceformer_inputs(cfg, B, T, seed, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    audio = np.stack([synthetic_wav(T / 25.0, seed + i) for i in range(B)])
    arrays = [audio, rng.standard_normal((B, T, cfg.vertice_dim)) * 0.3,
              rng.standard_normal((B, T, cfg.eye_dim)), rng.standard_normal((B, T, cfg.emo_dim)),
              rng.standard_normal((B, 1, cfg.vertice_dim))]
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


def phase_faceformer(kb, kba):
    """Full-width FaceFormerConfig() on 24 s of audio (B=1, T=600): the
    teacher-forced forward and the KV-cached predict with their K1 / K3
    launches, AR vs teacher-forced consistency, the forward on the card
    against the same weights on the CPU, repeatability, wall medians."""
    import numpy as np
    import torch

    from avi_talking_tpu_torch.models.faceformer import FaceFormerConfig

    cfg = FaceFormerConfig()
    B, T = 1, 600
    model = _faceformer_model(cfg, seed=0, device="cuda")
    audio, coeffs, eye, emo, ref = _faceformer_inputs(cfg, B, T, seed=20, device="cuda")
    with torch.no_grad():
        kb.launches = kba.launches = 0
        tf = model(audio, coeffs, eye, emo, ref)
        torch.cuda.synchronize()
        fwd_launches = {"keybias_attention": kb.launches, "fused_bias_attention": kba.launches}
        kb.launches = kba.launches = 0
        ar = model.predict(audio, T, eye, emo, ref)
        torch.cuda.synchronize()
        pred_launches = {"keybias_attention": kb.launches, "fused_bias_attention": kba.launches}
        check(fwd_launches == {"keybias_attention": 12, "fused_bias_attention": 2},
              f"the forward launched {fwd_launches}, not K1 12 and K3 2")
        check(pred_launches == {"keybias_attention": 12, "fused_bias_attention": 0},
              f"predict launched {pred_launches}, not K1 12 and K3 0")
        check(tf.shape == coeffs.shape and ar.shape == coeffs.shape,
              f"shapes {tuple(tf.shape)} / {tuple(ar.shape)}")
        check(bool(torch.isfinite(tf).all() and torch.isfinite(ar).all()), "non-finite output")
        tf_on_ar = model(audio, ar, eye, emo, ref)
        ar_err = float((tf_on_ar - ar).abs().max())
        check(torch.allclose(tf_on_ar, ar, rtol=2e-4, atol=2e-5),
              f"AR vs teacher-forced on its own outputs: max |d| {ar_err}")
        repeat = float((model(audio, coeffs, eye, emo, ref) - tf).abs().max())
        same_seed = _faceformer_model(cfg, seed=0, device="cuda")
        seed_diff = float((same_seed(audio, coeffs, eye, emo, ref) - tf).abs().max())
        check(repeat <= 1e-6 and seed_diff <= 1e-6,
              f"same input / same seed gave another output ({repeat}, {seed_diff})")
        del same_seed
        fwd_s, pred_s = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            model(audio, coeffs, eye, emo, ref)
            torch.cuda.synchronize()
            fwd_s.append(time.perf_counter() - t0)
        for _ in range(3):
            t0 = time.perf_counter()
            model.predict(audio, T, eye, emo, ref)
            torch.cuda.synchronize()
            pred_s.append(time.perf_counter() - t0)
        cpu = _faceformer_model(cfg, seed=0, device="cpu")
        t0 = time.perf_counter()
        c = cpu(*(t.cpu() for t in (audio, coeffs, eye, emo, ref)))
        cpu_s = time.perf_counter() - t0
        cpu_err = float((tf.cpu() - c).abs().max())
    tol = 1e-3  # fp32 on both (TF32 off); 12 + 1 layers reorder their sums
    check(cpu_err < tol, f"FaceFormer forward, card vs CPU: max |d| {cpu_err} >= {tol}")
    emit({"phase": "faceformer", "config": "FaceFormerConfig()", "batch": B, "frames": T,
          "audio_s": T / 25.0, "forward_launches": fwd_launches, "predict_launches": pred_launches,
          "finite": True, "ar_vs_tf_max_abs_diff": ar_err, "ar_vs_tf_tol": {"rtol": 2e-4, "atol": 2e-5},
          "gpu_vs_cpu_max_abs_err": cpu_err, "gpu_vs_cpu_tol": tol,
          "max_abs_output": float(tf.abs().max()), "same_input_max_abs_diff": repeat,
          "same_seed_max_abs_diff": seed_diff,
          "forward_wall_s_median": statistics.median(fwd_s), "forward_wall_s_all": fwd_s,
          "predict_wall_s_median": statistics.median(pred_s), "predict_wall_s_all": pred_s,
          "predict_ms_per_frame": statistics.median(pred_s) / T * 1e3, "cpu_forward_wall_s": cpu_s})
    return fwd_launches


def step_diffs(pair, rel_floor: float = 0.0) -> dict:
    """How far one optimizer step on the card lies from the same step on the
    CPU: ``pair[dev]`` is (loss, {name: tensor the step trained}). The loss;
    the weights where the CPU's |g| >= the floor (1e-6, or ``rel_floor`` of
    the model's largest gradient where that is larger) and the others; each
    gradient tensor whose largest entry is >= 1e-6, against that entry (the
    worst tensor named); every gradient entry against the model's largest."""
    import torch

    (loss_g, t_g), (loss_c, t_c) = pair["cuda"], pair["cpu"]
    p_g = {k: t.detach().cpu() for k, t in t_g.items()}
    g_g = {k: t.grad.cpu() for k, t in t_g.items() if t.grad is not None}
    p_c = {k: t.detach().cpu() for k, t in t_c.items()}
    g_c = {k: t.grad.cpu() for k, t in t_c.items() if t.grad is not None}
    param_err, noisy_err, noisy_n, grad_rel, worst = 0.0, 0.0, 0, 0.0, None
    g_max = max(float(g.abs().max()) for g in g_c.values())
    floor = max(1e-6, rel_floor * g_max)
    grad_abs = max(float((g_g[k] - g).abs().max()) for k, g in g_c.items()) / g_max
    for k, pc in p_c.items():
        d = (p_g[k] - pc).abs()
        well = torch.ones_like(d, dtype=torch.bool) if k not in g_c else g_c[k].abs() >= floor
        if bool(well.any()) and float(d[well].max()) > param_err:
            param_err = float(d[well].max())
        if not bool(well.all()):
            noisy_n += int((~well).sum())
            noisy_err = max(noisy_err, float(d[~well].max()))
        if k in g_c and float(g_c[k].abs().max()) >= 1e-6:
            rel = float((g_g[k] - g_c[k]).abs().max() / g_c[k].abs().max())
            if rel > grad_rel:
                grad_rel, worst = rel, k
    return {"loss": loss_c, "loss_abs_diff": abs(loss_g - loss_c), "grad_floor": floor,
            "param_max_abs_diff_where_grad_ge_floor": param_err,
            "param_max_abs_diff_where_grad_lt_floor": noisy_err, "elements_grad_lt_floor": noisy_n,
            "grad_max_rel_diff": grad_rel, "grad_worst_tensor": worst,
            "grad_max_abs_diff_over_largest_grad": grad_abs, "largest_grad": g_max}


def one_step_card_vs_cpu(pair, lr: float, loss_tol: float) -> dict:
    """Holds one optimizer step on the card to the same step on the CPU,
    from the same weights and batch (``step_diffs``). AdamW's first step
    moves a weight by lr * g / (|g| + 1e-8): where |g| is below about 100 *
    eps (the wav2vec2 k_proj biases, whose exact gradient is 0 by the
    softmax's shift invariance, carry rounding noise of 1e-10) the update
    follows the gradient's last bits and two right implementations may
    differ by up to 2 * lr. So the weights are held to 1e-4 where |g| >=
    1e-6 and the rest only to 2 * lr; each gradient tensor whose largest
    entry is >= 1e-6 to 1e-3 of that entry, every gradient entry to 1e-5 of
    the largest gradient of the model, and the loss to ``loss_tol``."""
    d = step_diffs(pair)
    tol = 1e-4
    check(d["loss_abs_diff"] < loss_tol and d["param_max_abs_diff_where_grad_ge_floor"] < tol
          and d["param_max_abs_diff_where_grad_lt_floor"] <= 2 * lr + 1e-6
          and d["grad_max_rel_diff"] < 1e-3 and d["grad_max_abs_diff_over_largest_grad"] < 1e-5,
          f"one training step, card vs CPU: loss |d| {d['loss_abs_diff']} (tol {loss_tol}), "
          f"weights max |d| {d['param_max_abs_diff_where_grad_ge_floor']} (|g| >= 1e-6) and "
          f"{d['param_max_abs_diff_where_grad_lt_floor']} (the {d['elements_grad_lt_floor']} "
          f"others), gradients {d['grad_max_rel_diff']} of their tensor's largest "
          f"({d['grad_worst_tensor']}), {d['grad_max_abs_diff_over_largest_grad']} of the "
          "model's largest")
    return {**d, "loss_tol": loss_tol, "tol": tol}


def phase_train_faceformer(kb, kba):
    """`cli train-faceformer` at its defaults (B=16, T=25, lr 1e-4) for 5
    steps on the card, with the K1 / K3 launches per step; then the same
    training at B=16 stepped directly for its step time; then one step at
    B=2 on the card against the same step on the CPU."""
    import contextlib
    import io

    import torch

    from avi_talking_tpu_torch.cli import main as cli_main
    from avi_talking_tpu_torch.cli.train import synthetic_batches
    from avi_talking_tpu_torch.models.faceformer import FaceFormerConfig
    from avi_talking_tpu_torch.train.faceformer_trainer import FaceFormerTrainer
    from avi_talking_tpu_torch.train.optim import adamw

    steps = 5
    buf = io.StringIO()
    kb.launches = kba.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["train-faceformer", "--steps", str(steps)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {"keybias_attention": kb.launches, "fused_bias_attention": kba.launches}
    check(rc == 0, f"train-faceformer exited {rc}")
    check(launches == {"keybias_attention": 12 * steps, "fused_bias_attention": 2 * steps},
          f"{steps} training steps launched {launches}, not K1 12 and K3 2 per step")
    final = [line for line in buf.getvalue().splitlines() if line.startswith("final:")]
    check(len(final) == 1, f"train-faceformer printed {buf.getvalue()!r}")
    final_loss = float(final[0].split("'loss': ")[1].rstrip("}"))
    check(math.isfinite(final_loss), f"final loss {final_loss}")

    cfg = FaceFormerConfig()
    model = _faceformer_model(cfg, seed=0, device="cuda")
    trainer = FaceFormerTrainer(model=model, optimizer=adamw(model.parameters(), 1e-4))
    batches = synthetic_batches(cfg, 16, 25, seed=0, device="cuda")
    losses, step_s = [], []
    for _ in range(6):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    check(all(math.isfinite(x) for x in losses), f"training losses {losses}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    del trainer, model

    pair = {}
    batch = next(synthetic_batches(cfg, 2, 25, seed=1, device="cpu"))
    for dev in ("cuda", "cpu"):
        m = _faceformer_model(cfg, seed=2, device=dev)
        tr = FaceFormerTrainer(model=m, optimizer=adamw(m.parameters(), 1e-4))
        loss = float(tr.train_step({k: v.to(dev) for k, v in batch.items()})["loss"])
        pair[dev] = (loss, dict(m.named_parameters()))
    one_step = one_step_card_vs_cpu(pair, lr=1e-4, loss_tol=1e-4)
    emit({"phase": "train_faceformer", "cli": f"train-faceformer --steps {steps}",
          "batch": 16, "seq_length": 25, "cli_wall_s": cli_s, "final": final[0],
          "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
          "direct_losses": losses, "step_s_all": step_s,
          "step_s_median_after_first": statistics.median(step_s[1:]),
          "peak_allocated_gib": peak_gib,
          "gpu_vs_cpu_one_step_B2": one_step})
    return launches


def _emote_trainer(head, lr, disentangle=None):
    from avi_talking_tpu_torch.train.optim import adamw
    from avi_talking_tpu_torch.train.talking_head import TalkingHeadTrainer, emote_trainables

    return TalkingHeadTrainer(head=head, optimizer=adamw(emote_trainables(head), lr),
                              disentangle=disentangle)


def _trained(module) -> dict:
    """The tensors of ``module`` that an optimizer step trained, by name."""
    import itertools

    return {k: t for k, t in itertools.chain(module.named_parameters(), module.named_buffers())
            if t.requires_grad}


def phase_train_emote(kb):
    """`train-emote`'s training at full width (EmoteConfig(): wav2vec2-base,
    decoder 128, FLINT q=3) and its defaults (B=8, 64 frames, lr 1e-4): the
    shape K1 sees, K1's launches per step, the median step seconds of 5
    after a warm-up; one step at B=2 on the card against the CPU from the
    same weights; then the `train-emote` command for two stages of 3 steps
    with validation every 3 and a run directory: its files, its K1
    launches, and `last` restored into a fresh head giving the logged
    final validation loss again."""
    import contextlib
    import io
    import itertools
    import tempfile

    import numpy as np
    import torch

    from avi_talking_tpu_torch.cli import main as cli_main
    from avi_talking_tpu_torch.cli.train_emote import build_head, synthetic_batches
    from avi_talking_tpu_torch.infra.checkpoint import restore_checkpoint
    from avi_talking_tpu_torch.train.emote_driver import validate

    B, T, lr = 8, 64, 1e-4
    head = build_head(tiny=False, seed=0, device=torch.device("cuda"))
    cfg = head.cfg
    batches = synthetic_batches(np.random.default_rng(0), B, T, cfg.flint.n_exp, cfg.n_shape,
                                "cuda")
    trainer = _emote_trainer(head, lr)
    seen = {}

    def conv_frames(module, args, out):  # a hook that returns None changes nothing
        seen["conv_frames"] = out.shape[1]

    def encoder_input(module, args):
        seen["encoder_input"] = list(args[0].shape)

    hooks = [head.audio_encoder.feature_extractor.register_forward_hook(conv_frames),
             head.audio_encoder.encoder.layers[0].register_forward_pre_hook(encoder_input)]
    losses, step_s, per_step = [], [], []
    for _ in range(6):
        batch = next(batches)
        torch.cuda.synchronize()
        kb.launches = 0
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append(kb.launches)
        losses.append(float(metrics["loss"]))
    for h in hooks:
        h.remove()
    k1_shape = [B, cfg.wav2vec2.num_attention_heads, seen["encoder_input"][1],
                seen["encoder_input"][1], cfg.wav2vec2.hidden_size // cfg.wav2vec2.num_attention_heads]
    check(seen["encoder_input"] == [B, T, cfg.wav2vec2.hidden_size],
          f"the encoder saw {seen['encoder_input']}, not [{B}, {T}, 768]")
    check(per_step == [12] * 6, f"EMOTE training steps launched K1 {per_step} times, not 12 each")
    check(all(math.isfinite(x) for x in losses), f"EMOTE training losses {losses}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    del trainer, head

    pair = {}
    batch = next(synthetic_batches(np.random.default_rng(1), 2, T, cfg.flint.n_exp, cfg.n_shape,
                                   "cpu"))
    for dev in ("cuda", "cpu"):
        m = build_head(tiny=False, seed=2, device=torch.device(dev))
        tr = _emote_trainer(m, lr)
        loss = float(tr.train_step({k: v.to(dev) for k, v in batch.items()})["loss"])
        pair[dev] = (loss, _trained(m))
    one_step = one_step_card_vs_cpu(pair, lr=lr, loss_tol=1e-4 * abs(pair["cpu"][0]))
    del pair

    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        run = os.path.join(tmp, "run")
        buf = io.StringIO()
        kb.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["train-emote", "--steps", "3", "--val-every", "3", "--run-dir", run])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_launches = kb.launches
        check(rc == 0, f"train-emote exited {rc}")
        # 2 stages x (3 steps + 1 validation of 2 batches), 12 launches each
        check(cli_launches == 12 * 2 * (3 + 2),
              f"train-emote launched K1 {cli_launches} times, not {12 * 2 * (3 + 2)}")
        for path in ("cfg.json", "checkpoints/best/state.pt", "checkpoints/last/state.pt",
                     "logs/scalars.jsonl"):
            check(os.path.exists(os.path.join(run, path)), f"train-emote wrote no {path}")
        logged = [json.loads(line) for line in open(os.path.join(run, "logs", "scalars.jsonl"))]
        val_loss = [e["emote_val/disentangled/loss"] for e in logged
                    if "emote_val/disentangled/loss" in e]
        check(len(val_loss) == 1, f"logged final validation losses {val_loss}")
        last = restore_checkpoint(os.path.join(run, "checkpoints", "last"), map_location="cuda")
        check(last["step"] == 6, f"last holds step {last['step']}")
        head = build_head(tiny=False, seed=5, device=torch.device("cuda"))
        head.load_state_dict(last["params"])
        val_batches = list(itertools.islice(synthetic_batches(
            np.random.default_rng(99_991), B, T, cfg.flint.n_exp, cfg.n_shape, "cuda"), 2))
        again = validate(_emote_trainer(head, lr, "condition_exchange"), lambda: iter(val_batches),
                          seed=0, device=torch.device("cuda"))["loss"]
        restore_err = abs(again - val_loss[0]) / abs(val_loss[0])
        check(restore_err < 1e-6, f"last restored: validation loss {again} against the logged "
              f"{val_loss[0]} (relative {restore_err})")
        del head
    emit({"phase": "train_emote", "config": "EmoteConfig()", "batch": B, "frames": T, "lr": lr,
          "conv_extractor_frames": seen["conv_frames"], "encoder_input": seen["encoder_input"],
          "k1_shape": k1_shape, "k1_launches_per_step": per_step, "losses": losses,
          "step_s_all": step_s, "step_s_median_after_first": statistics.median(step_s[1:]),
          "peak_allocated_gib": peak_gib, "gpu_vs_cpu_one_step_B2": one_step,
          "cli": "train-emote --steps 3 --val-every 3 --run-dir <tmp>", "cli_wall_s": cli_s,
          "cli_k1_launches": cli_launches, "final_val_loss": val_loss[0],
          "restored_last_val_loss": again, "restored_rel_diff": restore_err})
    return {"launches": cli_launches, "k1_shape": k1_shape}


NEURAL_TERMS = ("loss_lipread", "loss_emotion", "loss_video_emotion",
                "loss_lipread_disentangled", "loss_emotion_disentangled",
                "loss_video_emotion_disentangled")


def _winners(ndc, faces, size):
    """The face that wins each pixel of the size^2 render of ``ndc`` (N, V,
    3) vertices, -1 where none does, through the binning and visibility of
    the kernel route on their device (K2 on the card, its plain version on
    the CPU) -> (N, H, W) on the CPU."""
    import torch

    from avi_talking_tpu_torch.ops.kernels.rasterize import rasterize_tiles_visibility
    from avi_talking_tpu_torch.viz.rasterizer import _auto_tile, _untile, _visibility_inputs

    tile = _auto_tile(size, size, faces.shape[0])
    with torch.no_grad():
        ids, tri, valid, px, py, *_ = _visibility_inputs(ndc, faces, size, size, tile, 1024)
        _, slot = rasterize_tiles_visibility(tri, valid, px, py)
        gid = torch.where(slot >= 0, ids.reshape(slot.shape[0], -1).gather(
            1, slot.clamp_min(0).long()), -1)
        n = size // tile
        return _untile(gid.reshape(ndc.shape[0], n * n, -1, 1), n, n, tile)[..., 0].cpu()


def _view_winners(renderer, verts):
    """``_winners`` of the front view's render of verts (N, V, 3)."""
    return _winners(renderer.project(verts), renderer.faces, renderer.image_size)


def _neural_trainer(head, neural, lr):
    from avi_talking_tpu_torch.train.optim import adamw
    from avi_talking_tpu_torch.train.talking_head import TalkingHeadTrainer, emote_trainables

    return TalkingHeadTrainer(head=head, optimizer=adamw(emote_trainables(head), lr),
                              neural=neural, disentangle="condition_exchange")


# The vertex gradient through render and towers, card vs CPU on identical
# vertices, as a share of its largest entry: the towers' max-pools route a
# near-tie's gradient by the last bits, and a +-1e-7 change of the rendered
# video moves this gradient by 2.4e-4 on the CPU alone (PERF.md §6); twice
# that, rounded up.
VERTEX_GRAD_REL = 5e-4

# The same through the emotion loss's render and FAN backbone
# (train-faceformer-vert), whose 2x2 max-pools route near-ties in the same
# way: +-1e-7 on the rendered images moves this gradient by 2.24e-3 of its
# largest on the CPU alone (PERF.md §6); twice that, rounded up.
FAN_VERTEX_GRAD_REL = 5e-3


def _kernel_route_renderer(faces, size, device):
    """A FixedViewRenderer that renders through the kernel route on any
    device: K2's plain version on the CPU, where the package's own route is
    the plain binned one (a different visibility, and an autograd that keeps
    (tiles, cap, pixels) temporaries)."""
    import functools
    from unittest import mock

    from avi_talking_tpu_torch.viz import shading
    from avi_talking_tpu_torch.viz.rasterizer import rasterize_auto
    from avi_talking_tpu_torch.viz.visualizer import FixedViewRenderer

    class KernelRoute(FixedViewRenderer):
        def render_torch(self, verts, view=0):
            with mock.patch.object(shading, "rasterize_auto",
                                   functools.partial(rasterize_auto, backend="kernel")):
                return super().render_torch(verts, view)

    return KernelRoute(faces, size, device=device)


def _recording(loss):
    """``loss`` wrapped to keep, of its last call, the predicted vertices
    (its first argument), its value and the gradient that reaches the
    vertices through it (on the CPU) -> (the wrapper, what it keeps)."""
    seen = {}

    def wrapped(vertices, *args):
        v = vertices.view_as(vertices)
        v.register_hook(lambda g: seen.__setitem__("cotangent", g.detach().cpu()))
        out = loss(v, *args)
        seen.update(vertices=vertices.detach().cpu(), value=float(out.detach()))
        return out
    return wrapped, seen


def _replay(init: dict, grads: dict, optimizer) -> dict:
    """``init`` after one step on the CPU of ``optimizer(params)`` (the
    trainers' ``adamw`` or ``adam`` at their lr) with ``grads`` (a tensor
    without a gradient stays)."""
    params = {k: t.clone().requires_grad_() for k, t in init.items()}
    for k, p in params.items():
        p.grad = grads.get(k)
    optimizer(list(params.values())).step()
    return {k: p.detach() for k, p in params.items()}


def _neural_chain(neural, verts, gt_video, batch, perm, image_noise=None, backward=True):
    """The neural terms of predicted ``verts`` (2B, T, V, 3) against the
    rendered ``gt_video`` (B, T, H, W, 3) on ``neural``'s device: render,
    towers, losses; with ``backward`` also the gradient of the loss in the
    vertices and in the rendered video. ``image_noise`` is added to the
    rendered video first (a perturbation of the size of its rounding)."""
    import torch

    dev = neural.renderer.device
    v = verts.to(dev).clone().requires_grad_(backward)
    with torch.set_grad_enabled(backward):
        video = neural.render_video(v)
        if image_noise is not None:
            video = video + image_noise.to(dev)
        if backward:
            video.retain_grad()
        terms = {}
        loss = neural.video_loss(video, gt_video, {k: x.to(dev) for k, x in batch.items()},
                                 gt_video.shape[0], perm, terms)
        terms["loss"] = loss
        out = {"terms": {k: float(x.detach()) for k, x in terms.items()}}
        if backward:
            loss.backward()
            out.update(vertex_grad=v.grad.cpu().clone(), video_grad=video.grad.cpu().clone())
    return out


def _rel(a: dict, b: dict) -> dict:
    return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b}


def _max_rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def phase_train_emote_neural(kb, kras, peaks, profile=False):
    """EMOTE's neural-loss stage at full width.

    1. `train-emote --neural` at B=2, 32 frames, two stages of 2 steps with
       validation every 2 and a run directory: every loss term logged
       finite, K1 and K2 launches.
    2. One neural step at B=2, 8 frames (one latent frame) on the card and
       on the CPU from the same weights and exchange permutation, the CPU
       rendering through the same route (K2's plain version): the loss and
       the predicted vertices within 1e-4; each neural term within 1e-4 at
       the same vertices (the card's) on both sides, and printed for the
       two steps as they ran, with the pixels whose winning face changed
       between the two sides' predicted vertices and how far the CPU's own
       terms move at the card's vertices. The update three ways: the card's
       weights within lr / 100 (+ 1e-6 |w|) of AdamW on the CPU with the
       card's gradients; the independent steps' weights by the 2·lr rule
       with its floor at 1e-3 of the largest gradient; and the CPU's head
       stepped with the neural terms' gradient at the vertices taken from
       the card, by ``one_step_card_vs_cpu`` as it stands.
    3. Identical vertices on both sides: winners equal, every term within
       1e-4, the render's backward from one image gradient within 1e-4;
       the vertex gradient through render and towers within
       ``VERTEX_GRAD_REL`` of its largest, beside how far +-1e-7 on the
       rendered video moves it on the CPU alone.
    4. The step at B=2, 32 frames: median of 5 after a warm-up, K2
       launches per step and device ms, peak memory; K2 at the predicted
       video's launch against its plain version, with its bound; under
       ``profile`` one profiled step."""
    import contextlib
    import functools
    import io
    import tempfile

    import numpy as np
    import torch

    from avi_talking_tpu_torch.cli import main as cli_main
    from avi_talking_tpu_torch.cli.train_emote import (
        build_head, build_neural, neural_assets, synthetic_batches)
    from avi_talking_tpu_torch.core.flame import FlameModel
    from avi_talking_tpu_torch.models.emote import EmoteConfig
    from avi_talking_tpu_torch.train.optim import adamw
    from avi_talking_tpu_torch.viz.rasterizer import _visibility_inputs

    B, T, lr = 2, 32, 1e-4
    steps = 2
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        run = os.path.join(tmp, "run")
        buf = io.StringIO()
        kb.launches = kras.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["train-emote", "--neural", "--batch-size", str(B), "--frames", str(T),
                           "--steps", str(steps), "--val-every", str(steps), "--run-dir", run])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_launches = {"keybias_attention": kb.launches,
                        "rasterize_tiles_visibility": kras.launches}
        check(rc == 0, f"train-emote --neural exited {rc}")
        # K1: 12 a forward, 2 stages x (2 steps + 2 validation batches); K2: the
        # neural stage alone, 2 a loss (predicted and gt video) over the same 4
        want = {"keybias_attention": 12 * 2 * (steps + 2),
                "rasterize_tiles_visibility": 2 * (steps + 2)}
        check(cli_launches == want, f"train-emote --neural launched {cli_launches}, not {want}")
        logged = {}
        for line in open(os.path.join(run, "logs", "scalars.jsonl")):
            logged.update(json.loads(line))
        val = {k.split("/")[-1]: v for k, v in logged.items()
               if k.startswith("emote_val/disentangled/")}
        terms = NEURAL_TERMS + ("loss", "loss_exp", "loss_exp_vel", "loss_jaw", "loss_jaw_vel")
        check(all(k in val and math.isfinite(val[k]) for k in terms),
              f"train-emote --neural logged {sorted(val)}; every one of {terms} must be finite")
        check("loss_vertex" not in val, "a synthetic batch got a vertex term")

    # (2) one step, card vs CPU; T=8 keeps the CPU's ResNet-50 at 224^2 short
    assets = neural_assets(tiny=False)
    cfg = EmoteConfig()
    n_exp, n_shape = cfg.flint.n_exp, cfg.n_shape
    batch = next(synthetic_batches(np.random.default_rng(1), B, 8, n_exp, n_shape, "cpu"))
    perm = torch.tensor([1, 0])
    pair, metrics, seen, suites, grads = {}, {}, {}, {}, {}
    for d in ("cuda", "cpu"):
        dev = torch.device(d)
        head = build_head(False, seed=2, device=dev, flame_assets=assets)
        neural = build_neural(False, assets.faces, dev)
        if d == "cpu":  # the card's route: K2's plain version
            neural.renderer = _kernel_route_renderer(assets.faces, 224, dev)
        neural.loss, seen[d] = _recording(neural.loss)
        t0 = time.perf_counter()
        m = _neural_trainer(head, neural, lr).train_step({k: v.to(dev) for k, v in batch.items()},
                                                         perm=perm)
        metrics[d] = {k: float(v) for k, v in m.items()}
        metrics[d + "_step_s"] = time.perf_counter() - t0
        pair[d] = (metrics[d]["loss"], _trained(head))
        grads[d] = {k: t.grad.cpu() for k, t in pair[d][1].items() if t.grad is not None}
        suites[d] = neural
    verts = {d: s["vertices"] for d, s in seen.items()}
    renderers = {d: s.renderer for d, s in suites.items()}
    # K2 on both sides' vertices (bit-equal to its plain version on the same
    # inputs) for the pixels that changed winner; the plain version on the
    # CPU's for the identical-vertices check below
    winners = {d: _view_winners(renderers[d], verts["cpu"].to(d).flatten(0, 1))
               for d in ("cuda", "cpu")}
    changed = (_view_winners(renderers["cuda"], verts["cuda"].cuda().flatten(0, 1))
               != winners["cuda"])
    winners_changed = int(changed.sum())
    in_mouth = int(renderers["cpu"].crop_mouth(changed[..., None]).sum())
    vert_err = _max_rel(verts["cuda"], verts["cpu"])
    step_rel = _rel(metrics["cuda"], metrics["cpu"])
    # the independent step's update: the 2·lr rule with its floor at 1e-3 of
    # the model's largest gradient, ten times the gap that the changed
    # winners and the towers' near-ties put into the gradients, so that no
    # weight held to 1e-4 can have its AdamW step's sign flipped by them
    step = step_diffs(pair, rel_floor=1e-3)
    # the card's update: AdamW on the CPU from the same initial weights with
    # the card's gradients; a skipped, sign-flipped or mis-scaled step moves
    # a weight by lr or more
    head = build_head(False, seed=2, device=torch.device("cpu"), flame_assets=assets)
    init = {k: t.detach().clone() for k, t in _trained(head).items()}
    replay = _replay(init, grads["cuda"], functools.partial(adamw, lr=lr))
    update = {"max_abs_diff": max(float((pair["cuda"][1][k].detach().cpu() - w).abs().max())
                                  for k, w in replay.items()),
              "max_abs_diff_over_limit": max(
                  float(((pair["cuda"][1][k].detach().cpu() - w).abs()
                         / (lr / 100 + 1e-6 * w.abs())).max()) for k, w in replay.items())}
    # the head's step under the card's neural gradient: the CPU's head with
    # the neural terms replaced by their value and their gradient at the
    # vertices on the card; PR 8's rule as it stands (one_step_card_vs_cpu)
    card = seen["cuda"]

    def card_neural(v, *args):
        lin = (v * card["cotangent"]).sum()
        return lin - lin.detach() + card["value"]
    stand_in = types.SimpleNamespace(any_enabled=lambda: True, loss=card_neural)
    m = _neural_trainer(head, stand_in, lr).train_step(batch, perm=perm)
    head_step = one_step_card_vs_cpu({"cuda": pair["cuda"], "cpu": (float(m["loss"]), _trained(head))},
                                     lr=lr, loss_tol=1e-4 * abs(metrics["cpu"]["loss"]))
    # the batch's gt vertices, decoded as the trainer decodes them, rendered once a side
    jaw = batch["gt_jaw"].reshape(B * 8, 3)
    gt = FlameModel(assets, n_shape=n_shape, n_exp=n_exp).vertices_only(
        torch.zeros(B * 8, n_shape), batch["gt_exp"].reshape(B * 8, n_exp),
        torch.cat([torch.zeros_like(jaw), jaw], -1)).reshape(B, 8, -1, 3)
    with torch.no_grad():
        gt_video = {d: suites[d].render_video(gt.to(d)) for d in ("cuda", "cpu")}

    # (3) identical vertices (the CPU's predicted ones) on both sides:
    # winners, terms, the vertex gradient through render and towers; the
    # CPU's own with the rendered video perturbed by +-1e-7, which shows how
    # far the towers' max-pools let a rounding-sized change of the image move
    # that gradient; and the card's render backward from the CPU's image
    # gradient (on the CPU that is the chain's own vertex gradient)
    noise = (torch.rand((2 * B, 8, 224, 224, 3), generator=torch.Generator().manual_seed(5))
             - 0.5) * 2e-7
    chain = {d: _neural_chain(suites[d], verts["cpu"], gt_video[d], batch, perm)
             for d in ("cuda", "cpu")}
    noisy = _neural_chain(suites["cpu"], verts["cpu"], gt_video["cpu"], batch, perm,
                          image_noise=noise)
    v = verts["cpu"].cuda().requires_grad_()
    (suites["cuda"].render_video(v) * chain["cpu"]["video_grad"].cuda()).sum().backward()
    vg = {d: c["vertex_grad"] for d, c in chain.items()}
    same = {"winners_differing": int((winners["cuda"] != winners["cpu"]).sum()),
            "terms_rel_diff": _rel(chain["cuda"]["terms"], chain["cpu"]["terms"]),
            "vertex_grad_rel": _max_rel(vg["cuda"], vg["cpu"]),
            "vertex_grad_l2_rel": float((vg["cuda"] - vg["cpu"]).norm() / vg["cpu"].norm()),
            "vertex_grad_limit": VERTEX_GRAD_REL,
            "cpu_vertex_grad_rel_under_image_noise": _max_rel(noisy["vertex_grad"], vg["cpu"]),
            "video_grad_rel": _max_rel(chain["cuda"]["video_grad"], chain["cpu"]["video_grad"]),
            "render_backward_vertex_grad_rel": _max_rel(v.grad.cpu(), vg["cpu"])}
    # each side's neural terms at the card's predicted vertices; and the CPU's
    # at its own, which the card's rounding of the vertices moves by this much
    at_card = {d: _neural_chain(suites[d], verts["cuda"], gt_video[d], batch, perm,
                                backward=False)["terms"] for d in ("cuda", "cpu")}
    same_verts_rel = _rel(at_card["cuda"], at_card["cpu"])
    vertex_rounding_moves = _rel(at_card["cpu"], chain["cpu"]["terms"])
    one_step = {**step, "update_vs_adamw_on_the_cards_gradients": update,
                "head_step_under_the_cards_neural_gradient": head_step}
    emit({"phase": "train_emote_neural_card_vs_cpu",
          "one_step": {"rel_diff": step_rel, "predicted_vertices_rel_diff": vert_err,
                       "pixels_changed_winner": winners_changed,
                       "of_them_in_the_mouth_crop": in_mouth,
                       "terms_at_the_same_vertices_rel_diff": same_verts_rel,
                       "cpu_terms_moved_by_the_cards_vertex_rounding": vertex_rounding_moves,
                       **one_step},
          "identical_vertices": same})
    check(same["winners_differing"] == 0, f"identical vertices: {same['winners_differing']} "
          "pixels' winners differ between K2 and its plain version")
    check(all(v < 1e-4 for v in same["terms_rel_diff"].values()),
          f"identical vertices, card vs CPU: terms {same['terms_rel_diff']}")
    check(same["render_backward_vertex_grad_rel"] < 1e-4,
          f"identical vertices and image gradient: the render's backward differs by "
          f"{same['render_backward_vertex_grad_rel']} of its largest")
    check(same["vertex_grad_rel"] < VERTEX_GRAD_REL,
          f"identical vertices: the vertex gradient through render and towers differs by "
          f"{same['vertex_grad_rel']} of its largest, past {VERTEX_GRAD_REL} (the CPU alone "
          f"moves it by {same['cpu_vertex_grad_rel_under_image_noise']} under +-1e-7 on the "
          "rendered video)")
    check(vert_err < 1e-4, f"one neural step: predicted vertices differ by {vert_err} of the "
          "largest")
    check(step_rel["loss"] < 1e-4 and all(v < 1e-4 for v in same_verts_rel.values()),
          f"one neural step, card vs CPU: loss {step_rel['loss']}, the neural terms at the same "
          f"vertices {same_verts_rel}")
    check(update["max_abs_diff_over_limit"] <= 1.0,
          f"one neural step: the card's weights lie {update['max_abs_diff']} from AdamW on its "
          f"own gradients, past lr / 100 + 1e-6 |w|")
    pixel_note = (f"; {winners_changed} pixels ({in_mouth} in the mouth crop) changed winning "
                  "face between the two sides' predicted vertices" if winners_changed else "")
    check(step["param_max_abs_diff_where_grad_ge_floor"] < 1e-4
          and step["param_max_abs_diff_where_grad_lt_floor"] <= 2 * lr + 1e-6,
          f"one neural step, card vs CPU: weights max |d| "
          f"{step['param_max_abs_diff_where_grad_ge_floor']} where |g| >= {step['grad_floor']} "
          f"(limit 1e-4), {step['param_max_abs_diff_where_grad_lt_floor']} elsewhere (limit "
          f"2·lr){pixel_note}")
    del pair, suites, renderers, chain, noisy, head, gt_video, grads, replay

    # (4) the timed step at B=2, T=32
    dev = torch.device("cuda")
    head = build_head(False, seed=0, device=dev, flame_assets=assets)
    neural = build_neural(False, assets.faces, dev)
    trainer = _neural_trainer(head, neural, lr)
    batches = synthetic_batches(np.random.default_rng(0), B, T, n_exp, n_shape, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, per_step, losses = [], [], []
    for _ in range(6):
        b = next(batches)
        torch.cuda.synchronize()
        kras.launches = 0
        t0 = time.perf_counter()
        m = trainer.train_step(b, generator=gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append(kras.launches)
        losses.append(float(m["loss"]))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(per_step == [2] * 6, f"neural steps launched K2 {per_step} times, not 2 each")
    check(all(math.isfinite(x) for x in losses), f"neural step losses {losses}")
    k2_step_ms = device_ms(lambda: trainer.train_step(b, generator=gen), "rasterize_visibility",
                           iters=3)
    prof = None
    if profile:
        prof = profile_call(lambda: trainer.train_step(b, generator=gen))
        emit({"phase": "profile", "call": "train_emote_neural_step", "batch": B, "frames": T,
              **prof})

    # K2 at the predicted video's launch (2B x T frames x 16 tiles)
    seen = {}
    hook = head.register_forward_hook(lambda m, a, out: seen.__setitem__("v", out["vertices"]))
    with torch.no_grad():
        trainer.loss_fn(b, generator=gen)
    hook.remove()
    del trainer, head
    ndc = neural.renderer.project(seen.pop("v").flatten(0, 1))
    _, tri, valid, px, py, *_ = _visibility_inputs(ndc, neural.renderer.faces, 224, 224, 56, 1024)
    z, s = kras.rasterize_tiles_visibility(tri, valid, px, py)
    torch.cuda.synchronize()
    # the plain version in slot chunks of 64 (its result does not depend on the
    # chunk) keeps its (tiles, chunk, pixels) temporaries near 1.6 GB
    rz, rs = kras.rasterize_tiles_visibility_reference(tri, valid, px, py, chunk=64)
    err = float((z - rz).abs().max())
    check(torch.equal(s, rs) and torch.equal(z, rz),
          f"K2 at the neural launch: not bit-equal to the plain version ({int((s != rs).sum())} "
          f"slots differ, max |dz| {err})")
    del z, s, rz, rs

    def kernel():
        return kras.rasterize_tiles_visibility(tri, valid, px, py)

    row = {"case": "neural_224_tile56", "shape": list(tri.shape[:2]) + [px.shape[1]],
           "frames": int(ndc.shape[0]), "faces": int(neural.renderer.faces.shape[0]),
           "valid_slots": int(valid.sum()), "live_slots_per_tile": live_slot_stats(valid),
           "max_abs_err": err, "ms": time_ms(kernel, iters=5, reps=5),
           "device_ms": device_ms(kernel, "rasterize_visibility", iters=5),
           "plain_ms": time_ms(lambda: kras.rasterize_tiles_visibility_reference(
               tri, valid, px, py, chunk=64), iters=1, reps=3)}
    row.update(visibility_bound(tri, valid, px, py, peaks))
    emit({"phase": "kernel_check", "kernel": "rasterize_tiles_visibility", **row})
    emit({"phase": "train_emote_neural", "config": "EmoteConfig(), synthetic FLAME 5023 / 9976, "
          "224^2 renders, towers at seeded random init", "batch": B, "frames": T, "lr": lr,
          "cli": f"train-emote --neural --batch-size {B} --frames {T} --steps {steps} "
                 f"--val-every {steps} --run-dir <tmp>",
          "cli_wall_s": cli_s, "cli_launches": cli_launches, "cli_val_metrics": val,
          "gpu_vs_cpu_one_step_B2_T8": {"metrics": metrics, "rel_diff": step_rel,
                                        "terms_at_the_same_vertices_rel_diff": same_verts_rel,
                                        "pixels_changed_winner": winners_changed, **one_step},
          "identical_vertices": same, "rtol": 1e-4,
          "losses": losses, "step_s_all": step_s,
          "step_s_median_after_first": statistics.median(step_s[1:]),
          "frames_per_s": B * T / statistics.median(step_s[1:]),
          "k2_launches_per_step": per_step, "k2_device_ms_per_step": k2_step_ms,
          "k2_device_ms_per_launch": None if k2_step_ms is None else k2_step_ms / 2,
          "peak_allocated_gib": peak_gib,
          "device_idle_share": None if prof is None else prof["device_idle_share"]})
    return {"launches": cli_launches, "row": row}


def _write_mead_tree(root, n_clips, frames, seed, names=None, crop_size=None):
    """A MEAD-layout root as the data tests build one: ``n_clips`` clips of
    ``frames`` frames (identities M003 / W009, emotions neutral / happy /
    angry / sad / surprised; or the clips ``names``), each frame's EMOCA exp
    (50), pose (6), shape (100) and cam (3) npys, and the clip's 16 kHz wav;
    with ``crop_size``, each frame's crop_size^2 detection crop under
    ``EMOCA_v2_lr_mse_20/processed_x/detections`` (written by the port's
    ``write_png``: 16 px blocks that drift by frame, smooth enough to keep
    the files small)."""
    import wave

    import numpy as np

    from avi_talking_tpu_torch.viz.pngio import write_png

    rng = np.random.default_rng(seed)
    emotions = ("neutral", "happy", "angry", "sad", "surprised")
    if crop_size:
        yy, xx = np.mgrid[0:crop_size, 0:crop_size] // 16
        blocks = np.stack([xx * 4, yy * 4, (xx + yy) * 2], axis=-1)
    for c in range(n_clips):
        name = (names[c] if names else
                f"{('M003', 'W009')[c % 2]}_front_{emotions[c % 5]}_level1_{c:03d}")
        if crop_size:
            det = os.path.join(root, name, "EMOCA_v2_lr_mse_20", "processed_x", "detections")
            os.makedirs(det)
            for i in range(frames):
                write_png(os.path.join(det, f"{i:06d}_000.png"),
                          ((blocks + 3 * i + 37 * c) % 256).astype(np.uint8))
        for i in range(frames):
            fd = os.path.join(root, name, "EMOCA_v2_lr_mse_20", f"{i:06d}_000")
            os.makedirs(fd)
            for key, n, scale in (("exp", 50, 0.5), ("pose", 6, 0.1), ("shape", 100, 1.0),
                                  ("cam", 3, 1.0)):
                np.save(os.path.join(fd, f"{key}.npy"),
                        (rng.standard_normal(n) * scale).astype(np.float32))
        pcm = (np.clip(synthetic_wav(frames / 25.0, seed + c), -1, 1) * 32767).astype(np.int16)
        with wave.open(os.path.join(root, name, name + ".wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())


def _vert_model(cfg, template, seed, device):
    """Seeded FaceFormerVert with its zero-init output map filled."""
    from avi_talking_tpu_torch.models.faceformer_vert import FaceFormerVert

    return _fill_output_map(FaceFormerVert.random_init(cfg, template=template, seed=seed,
                                                       device=device), seed)


def _emo_chain(emo_cls, verts, labels, backward=True, image_noise=None):
    """The emotion term of predicted ``verts`` on emo_cls's device -> (value,
    its gradient in the vertices, its gradient in the rendered images, both
    on the CPU under ``backward``). ``image_noise`` is added to the rendered
    images first (a perturbation of the size of their rounding)."""
    import torch

    dev = emo_cls.faces.device
    seen = {}

    def fan_input(module, args):
        x = args[0] if image_noise is None else args[0] + image_noise.to(dev)
        if backward:
            x.retain_grad()
        seen["images"] = x
        return (x,)
    hook = emo_cls.fan.model.register_forward_pre_hook(fan_input)
    try:
        v = verts.to(dev).clone().requires_grad_(backward)
        with torch.set_grad_enabled(backward):
            out = emo_cls(v, labels.to(dev))
            if backward:
                out.backward()
    finally:
        hook.remove()
    if not backward:
        return float(out), None, None
    return float(out.detach()), v.grad.cpu(), seen["images"].grad.cpu()


def _vert_args(mead, npz, B, T, **kw):
    return types.SimpleNamespace(mead_root=mead, root=None, tiny=False, flame_npz=npz,
                                 batch_size=B, frames=T, fan_checkpoint=None,
                                 head_checkpoint=None, emo_cls_pretrain=False, **kw)


def phase_train_faceformer_vert(kb, kba, kras, peaks, profile=False):
    """Vertex-space FaceFormer training at full width (FaceFormerVertConfig():
    wav2vec2-base, vertice_dim 15069, 4 heads of 16, period 30) at the
    command's defaults (B=4, 100 frames, lr 1e-4), on a synthetic MEAD tree
    (5 clips of 120 frames) and a synthetic full-size FLAME npz (n_shape
    100, n_exp 50, 68-point landmark tables, 5023 vertices, 9976 random
    faces).

    a. `train-faceformer-vert` synthetic and `--disentangle`, 2 steps each
       with `--ckpt-dir`, each checkpoint loaded strictly into a fresh model;
    b. the main path: `--mead-root --disentangle --emo-cls` for 2 steps, K1,
       K3 and K2 counted (48, 8 and 1 a step);
    c. `--emo-cls-pretrain --ckpt-dir` for 2 steps (every frame rendered),
       then `--emo-cls --head-checkpoint` from it;
    d. one step at B=2, 40 frames, stride 20 (4 frames rendered at 224^2) on
       the card and on the CPU (rendering through the same kernel route, K2's
       plain version) from the same weights, batch and permutations, with
       region masks thresholded from the template so that the shuffle terms
       carry weight: the geometric terms within 1e-4 and the update by the
       2·lr rule (``one_step_card_vs_cpu`` on the CPU model stepped with the
       card's emotion-term gradient at the vertices); the emotion term split
       as the neural step's (at the same vertices within 1e-4; the card's weights
       within lr / 100 of Adam replayed on its own gradients; identical
       vertices: winners equal, the term within 1e-4, the render's backward
       from one image gradient within 1e-4, the vertex gradient through
       render and FAN within ``FAN_VERTEX_GRAD_REL``). The two independent
       steps' weights are reported, not held: the pixels that change winner
       between the sides' vertices move the gradients further than a
       rounding rule allows (PERF.md §6). Then one `train-faceformer` step
       with the landmark terms card vs CPU by ``one_step_card_vs_cpu``;
    e. the step at B=4, 100 frames: median of 5 after a warm-up, launches
       per step, peak memory, under ``profile`` a profiled step; K3 at the
       decoder's shape (B=4 H=4 T=S=100 d=16, both biases) forward and
       backward; K2 at the emotion loss's launch (20 frames x 16 tiles)
       against its plain version."""
    import ast
    import contextlib
    import dataclasses
    import functools
    import io
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    from avi_talking_tpu_torch.cli import main as cli_main
    from avi_talking_tpu_torch.cli.train import synthetic_batches as ff_batches
    from avi_talking_tpu_torch.cli.train_faceformer_vert import (
        batch_source, build_emo_cls, model_config, region_selector, template_selector)
    from avi_talking_tpu_torch.core.assets import synthetic_assets
    from avi_talking_tpu_torch.core.flame import FlameModel
    from avi_talking_tpu_torch.infra.checkpoint import restore_checkpoint
    from avi_talking_tpu_torch.models.faceformer import FaceFormerConfig
    from avi_talking_tpu_torch.models.faceformer_vert import FaceFormerVert, FaceFormerVertConfig
    from avi_talking_tpu_torch.ops.positional import enc_dec_alignment_bias, faceformer_bias
    from avi_talking_tpu_torch.train.emo_cls import EmoClsHead
    from avi_talking_tpu_torch.train.faceformer_trainer import FaceFormerTrainer
    from avi_talking_tpu_torch.train.faceformer_vert_trainer import FaceFormerVertTrainer
    from avi_talking_tpu_torch.train.optim import adam, adamw
    from avi_talking_tpu_torch.viz import rasterizer
    from avi_talking_tpu_torch.viz.rasterizer import _visibility_inputs

    B, T, lr = 4, 100, 1e-4
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def counts():
        return {"keybias_attention": kb.launches, "fused_bias_attention": kba.launches,
                "rasterize_tiles_visibility": kras.launches}

    def zero():
        kb.launches = kba.launches = kras.launches = 0

    def run_cli(*argv):
        buf = io.StringIO()
        zero()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            rc = cli_main(["train-faceformer-vert", *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"train-faceformer-vert {' '.join(argv)} exited {rc}")
        final = [ln for ln in buf.getvalue().splitlines() if ln.startswith("final:")]
        check(len(final) == 1, f"train-faceformer-vert printed {buf.getvalue()!r}")
        terms = ast.literal_eval(final[0][len("final:"):].strip())
        check(all(math.isfinite(v) for v in terms.values()), f"final terms {terms}")
        return {"argv": " ".join(argv), "wall_s": wall, "launches": counts(), "final": terms}

    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    runs = {}
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        mead, npz = os.path.join(tmp, "mead"), os.path.join(tmp, "flame.npz")
        t0 = time.perf_counter()
        _write_mead_tree(mead, n_clips=5, frames=120, seed=0)
        assets = synthetic_assets(num_vertices=5023, n_shape=100, n_exp=50, num_faces=9976,
                                  n_static_landmarks=51)
        np.savez(npz, **{f.name: getattr(assets, f.name).numpy()
                         for f in dataclasses.fields(assets)})
        setup_s = time.perf_counter() - t0

        # (a) synthetic and --disentangle, checkpoints loaded back
        for name, mode, forwards in (("synthetic", [], 1), ("disentangle", ["--disentangle"], 3)):
            ck = os.path.join(tmp, "ck_" + name)
            r = runs[name] = run_cli("--steps", "2", "--ckpt-dir", ck, *mode)
            want = {"keybias_attention": 12 * forwards * 2,
                    "fused_bias_attention": 2 * forwards * 2, "rasterize_tiles_visibility": 0}
            check(r["launches"] == want, f"{name}: launched {r['launches']}, not {want}")
            state = restore_checkpoint(ck)["params"]
            m = FaceFormerVert.random_init(FaceFormerVertConfig(num_train_subjects=2), device=cuda)
            m.load_state_dict(state, strict=True)
            check(all(bool(torch.isfinite(t).all()) for t in state.values())
                  and float(state["vertice_map_r.weight"].abs().max()) > 0,
                  f"{name}: the checkpoint holds non-finite or untrained weights")
            del m, state

        # (b) the main path, every kernel under one step
        main = runs["mead_disentangle_emo_cls"] = run_cli(
            "--steps", "2", "--mead-root", mead, "--flame-npz", npz, "--disentangle", "--emo-cls")
        want = {"keybias_attention": 48 * 2, "fused_bias_attention": 8 * 2,
                "rasterize_tiles_visibility": 2}
        check(main["launches"] == want, f"the main path launched {main['launches']}, not {want}")
        check(set(main["final"]) == {"verts", "verts_eye_area", "verts_mouth_area", "emo_cls"},
              f"the main path's terms {main['final']}")

        # (c) the pretrain round trip
        head_ck = os.path.join(tmp, "head")
        runs["pretrain"] = run_cli("--steps", "2", "--mead-root", mead, "--flame-npz", npz,
                                   "--emo-cls-pretrain", "--ckpt-dir", head_ck)
        check(runs["pretrain"]["launches"] == {"keybias_attention": 0, "fused_bias_attention": 0,
                                               "rasterize_tiles_visibility": 2},
              f"the pretrain stage launched {runs['pretrain']['launches']}")
        head_state = restore_checkpoint(head_ck)["emo_cls_head"]
        init = EmoClsHead.random_init(seed=6, device=cpu).state_dict()
        check(all(not torch.equal(head_state[k], init[k]) for k in ("0.weight", "2.running_var")),
              "the pretrain stage left the head's weights or statistics as they were")
        runs["head_checkpoint"] = run_cli("--steps", "1", "--mead-root", mead, "--flame-npz", npz,
                                          "--emo-cls", "--head-checkpoint", head_ck)

        # (d) one step card vs CPU at B=2, 40 frames
        Bd, Td = 2, 40
        srcs = {d: batch_source(_vert_args(mead, npz, Bd, Td), np.random.default_rng(0), d)
                for d in (cuda, cpu)}
        audio, payload, one_hot, emo_idx = srcs[cpu].batch()
        emo = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (Bd, Td, 30)).astype(np.float32))
        batch = (audio, payload, one_hot, emo, emo_idx)
        perms = (torch.tensor([1, 0]), torch.tensor([1, 0]))
        selector = template_selector(srcs[cpu].template)
        cfg = model_config(_vert_args(mead, npz, Bd, Td), srcs[cpu])
        kernel_route = functools.partial(rasterizer.rasterize_auto, backend="kernel")
        pair, grads, terms, seen, emo_fns = {}, {}, {}, {}, {}
        for dev in (cuda, cpu):
            d = dev.type
            emo_fns[d] = build_emo_cls(_vert_args(mead, npz, Bd, Td), srcs[dev], dev, Td)
            recording, seen[d] = _recording(emo_fns[d])
            model = _vert_model(cfg, srcs[cpu].template.to(dev), seed=2, device=dev)
            trainer = FaceFormerVertTrainer(model, adam(model.parameters(), lr),
                                            srcs[dev].to_verts, selector, recording)
            route = (mock.patch.object(rasterizer, "rasterize_auto", kernel_route) if d == "cpu"
                     else contextlib.nullcontext())
            t0 = time.perf_counter()
            with route:
                m = trainer.train_step(*(x.to(dev) for x in batch), perms=perms)
            terms[d] = {k: float(v) for k, v in m.items()}
            terms[d + "_step_s"] = time.perf_counter() - t0
            pair[d] = (sum(terms[d].values()), dict(model.named_parameters()))
            grads[d] = {k: t.grad.cpu() for k, t in pair[d][1].items() if t.grad is not None}
        geo_rel = {k: abs(terms["cuda"][k] - terms["cpu"][k]) / max(abs(terms["cpu"][k]), 1e-12)
                   for k in ("verts", "verts_eye_area", "verts_mouth_area")}
        vert_err = _max_rel(seen["cuda"]["vertices"], seen["cpu"]["vertices"])
        with mock.patch.object(rasterizer, "rasterize_auto", kernel_route):
            # the emotion term at the card's vertices on both sides, and the
            # CPU's at its own, which the card's rounding of them moves
            at_card = {d: _emo_chain(emo_fns[d], seen["cuda"]["vertices"], emo_idx,
                                     backward=False)[0] for d in ("cuda", "cpu")}
            # identical vertices (the CPU's): the term, its gradients in the
            # vertices and in the rendered images, and the CPU's own with the
            # images perturbed by +-1e-7, which shows how far FAN's max-pools
            # let a rounding-sized change move the vertex gradient
            chain = {d: _emo_chain(emo_fns[d], seen["cpu"]["vertices"], emo_idx)
                     for d in ("cuda", "cpu")}
            noise = (torch.rand((Bd * 2, 3, 224, 224), generator=torch.Generator().manual_seed(5))
                     - 0.5) * 2e-7
            noisy = _emo_chain(emo_fns["cpu"], seen["cpu"]["vertices"], emo_idx,
                               image_noise=noise)
            winners = {d: _winners(emo_fns[d].ndc(seen["cpu"]["vertices"].to(d)),
                                   emo_fns[d].faces, 224) for d in ("cuda", "cpu")}
        # the card's render backward from the CPU's image gradient (on the CPU
        # that is the chain's own vertex gradient)
        v = seen["cpu"]["vertices"].cuda().requires_grad_()
        (emo_fns["cuda"].images(v) * chain["cpu"][2].cuda()).sum().backward()
        changed = int((_winners(emo_fns["cuda"].ndc(seen["cuda"]["vertices"].cuda()),
                                emo_fns["cuda"].faces, 224) != winners["cuda"]).sum())
        vg = {d: c[1] for d, c in chain.items()}
        same = {"winners_differing": int((winners["cuda"] != winners["cpu"]).sum()),
                "term_rel_diff": abs(chain["cuda"][0] - chain["cpu"][0]) / abs(chain["cpu"][0]),
                "image_grad_rel": _max_rel(chain["cuda"][2], chain["cpu"][2]),
                "render_backward_vertex_grad_rel": _max_rel(v.grad.cpu(), vg["cpu"]),
                "vertex_grad_rel": _max_rel(vg["cuda"], vg["cpu"]),
                "vertex_grad_l2_rel": float((vg["cuda"] - vg["cpu"]).norm() / vg["cpu"].norm()),
                "cpu_vertex_grad_rel_under_image_noise": _max_rel(noisy[1], vg["cpu"]),
                "cpu_vertex_grad_l2_rel_under_image_noise": float(
                    (noisy[1] - vg["cpu"]).norm() / vg["cpu"].norm()),
                "vertex_grad_limit": FAN_VERTEX_GRAD_REL}
        at_card_rel = abs(at_card["cuda"] - at_card["cpu"]) / abs(at_card["cpu"])
        # the card's update: Adam on the CPU with the card's gradients
        init = {k: t.detach().cpu().clone() for k, t in _vert_model(
            cfg, srcs[cpu].template, seed=2, device=cpu).named_parameters()}
        replay = _replay(init, grads["cuda"], functools.partial(adam, lr=lr))
        update = {"max_abs_diff": max(float((pair["cuda"][1][k].detach().cpu() - w).abs().max())
                                      for k, w in replay.items()),
                  "max_abs_diff_over_limit": max(
                      float(((pair["cuda"][1][k].detach().cpu() - w).abs()
                             / (lr / 100 + 1e-6 * w.abs())).max()) for k, w in replay.items())}
        # the rest of the step under the card's emotion-term gradient at the
        # vertices: the CPU model with a stand-in term, by one_step_card_vs_cpu as it stands
        card = seen["cuda"]

        def stand_in(v, labels):
            lin = (v * card["cotangent"] * 10.0).sum()  # the trainer weighs the term by 0.1
            return lin - lin.detach() + card["value"]
        model = _vert_model(cfg, srcs[cpu].template, seed=2, device=cpu)
        m = FaceFormerVertTrainer(model, adam(model.parameters(), lr), srcs[cpu].to_verts,
                                  selector, stand_in).train_step(*batch, perms=perms)
        rest = one_step_card_vs_cpu(
            {"cuda": pair["cuda"], "cpu": (float(sum(m.values())), dict(model.named_parameters()))},
            lr=lr, loss_tol=1e-4 * abs(pair["cpu"][0]))
        step = step_diffs(pair, rel_floor=1e-3)
        emit({"phase": "train_faceformer_vert_card_vs_cpu", "batch": Bd, "frames": Td,
              "stride": emo_fns["cpu"].stride, "rendered_frames": Bd * -(-Td // 20),
              "terms": terms, "geometric_rel_diff": geo_rel,
              "predicted_vertices_rel_diff": vert_err, "pixels_changed_winner": changed,
              "emo_cls_at_the_same_vertices_rel_diff": at_card_rel,
              "cpu_emo_cls_moved_by_the_cards_vertex_rounding":
                  abs(at_card["cpu"] - chain["cpu"][0]) / abs(chain["cpu"][0]),
              "update_vs_adam_on_the_cards_gradients": update,
              "step_under_the_cards_emo_cls_gradient": rest, "independent_step": step,
              "identical_vertices": same})
        check(all(v < 1e-4 for v in geo_rel.values()), f"geometric terms card vs CPU: {geo_rel}")
        check(vert_err < 1e-4, f"predicted vertices card vs CPU: {vert_err} of the largest")
        check(at_card_rel < 1e-4, f"the emotion term at the same vertices: {at_card_rel}")
        check(same["winners_differing"] == 0 and same["term_rel_diff"] < 1e-4,
              f"identical vertices: {same['winners_differing']} winners differ, the term by "
              f"{same['term_rel_diff']}")
        check(same["render_backward_vertex_grad_rel"] < 1e-4,
              f"identical vertices and image gradient: the render's backward differs by "
              f"{same['render_backward_vertex_grad_rel']} of its largest")
        check(same["vertex_grad_rel"] < FAN_VERTEX_GRAD_REL,
              f"identical vertices: the vertex gradient through render and FAN differs by "
              f"{same['vertex_grad_rel']} of its largest, past {FAN_VERTEX_GRAD_REL} (the CPU "
              f"alone moves it by {same['cpu_vertex_grad_rel_under_image_noise']} under +-1e-7 "
              "on the rendered images)")
        check(float(vg["cpu"].abs().max()) > 0, "the emotion term has no vertex gradient")
        check(update["max_abs_diff_over_limit"] <= 1.0,
              f"the card's weights lie {update['max_abs_diff']} from Adam on its own gradients")
        del pair, grads, emo_fns, chain, noisy, replay, model, srcs, v, trainer, recording

        # the landmark terms of train-faceformer, one step card vs CPU
        fcfg = FaceFormerConfig()
        fbatch = next(ff_batches(fcfg, 2, 25, seed=1, device="cpu"))
        lpair = {}
        for d in ("cuda", "cpu"):
            fm = _faceformer_model(fcfg, seed=2, device=d)
            tr = FaceFormerTrainer(fm, adamw(fm.parameters(), lr),
                                   flame=FlameModel(assets.to(d), n_shape=100, n_exp=50),
                                   coeff_mean=torch.zeros(53, device=d),
                                   coeff_std=torch.ones(53, device=d))
            lm = tr.train_step({k: v.to(d) for k, v in fbatch.items()})
            check(float(lm["ldmk"]) > 0, f"the landmark term on the {d} is {float(lm['ldmk'])}")
            lpair[d] = (float(lm["loss"]), dict(fm.named_parameters()))
        landmark_step = one_step_card_vs_cpu(lpair, lr=lr, loss_tol=1e-4 * abs(lpair["cpu"][0]))
        del lpair, fm, tr

        # (e) the timed step at B=4, 100 frames
        args = _vert_args(mead, npz, B, T)
        src = batch_source(args, np.random.default_rng(0), cuda)
        emo_cls = build_emo_cls(args, src, cuda, T)
        cfg = model_config(args, src)
        model = FaceFormerVert.random_init(cfg, template=src.template, seed=0, device=cuda)
        trainer = FaceFormerVertTrainer(model, adam(model.parameters(), lr), src.to_verts,
                                        region_selector(args, src), emo_cls)
        gen = torch.Generator().manual_seed(0)
        rng = np.random.default_rng(1)
        shapes = {}
        hook = model.audio_encoder.encoder.layers[0].register_forward_pre_hook(
            lambda mod, a: shapes.__setitem__("encoder_input", list(a[0].shape)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_s, per_step, losses = [], [], []
        for _ in range(6):
            b = src.batch()
            e = torch.from_numpy(rng.standard_normal((B, T, 30)).astype(np.float32)).cuda()
            torch.cuda.synchronize()
            zero()
            t0 = time.perf_counter()
            m = trainer.train_step(*b[:3], e, b[3], generator=gen)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append(counts())
            losses.append(float(sum(m.values())))
        hook.remove()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {"keybias_attention": 48, "fused_bias_attention": 8, "rasterize_tiles_visibility": 1}
        check(all(c == want for c in per_step), f"the steps launched {per_step}, not {want} each")
        check(all(math.isfinite(x) for x in losses), f"step losses {losses}")
        hidden = cfg.wav2vec2.hidden_size
        check(shapes["encoder_input"] == [B, T, hidden],
              f"the encoder saw {shapes['encoder_input']}, not [{B}, {T}, {hidden}]")
        heads = cfg.wav2vec2.num_attention_heads
        k1_shape = [B, heads, T, T, hidden // heads]
        prof = None
        if profile:
            prof = profile_call(lambda: trainer.train_step(*b[:3], e, b[3], generator=gen))
            emit({"phase": "profile", "call": "train_faceformer_vert_step", "batch": B,
                  "frames": T, **prof})
        with torch.no_grad():
            pred = model(b[0], src.to_verts(b[1]), e, b[2])
        del trainer, model

        # K3 at the decoder's shape, forward and backward
        g = torch.Generator(device="cuda").manual_seed(11)
        d = cfg.d_model // cfg.nhead
        k3_rows = [bias_attention_row(f"vert_train_{kind}_d{d}", B, cfg.nhead, T, d, kind,
                                      cfg.period, peaks, g) for kind in ("HTT", "TS")]
        gc = torch.Generator().manual_seed(12)
        k3_grads = [attention_grad_row("fused_bias_attention", B, cfg.nhead, T, d, bias, peaks, gc)
                    for bias in (faceformer_bias(cfg.nhead, T, cfg.period),
                                 enc_dec_alignment_bias(T, T))]

        # K2 at the emotion loss's launch: B x T / stride frames x 16 tiles
        ndc = emo_cls.ndc(pred)
        _, tri, valid, px, py, *_ = _visibility_inputs(ndc, emo_cls.faces, 224, 224, 56, 1024)
        z, s = kras.rasterize_tiles_visibility(tri, valid, px, py)
        torch.cuda.synchronize()
        rz, rs = kras.rasterize_tiles_visibility_reference(tri, valid, px, py, chunk=64)
        err = float((z - rz).abs().max())
        check(torch.equal(s, rs) and torch.equal(z, rz),
              f"K2 at the emotion loss's launch: not bit-equal to the plain version "
              f"({int((s != rs).sum())} slots differ, max |dz| {err})")
        del z, s, rz, rs

        def kernel():
            return kras.rasterize_tiles_visibility(tri, valid, px, py)

        k2_row = {"case": "emo_cls_224_tile56", "shape": list(tri.shape[:2]) + [px.shape[1]],
                  "frames": int(ndc.shape[0]), "faces": int(emo_cls.faces.shape[0]),
                  "valid_slots": int(valid.sum()), "live_slots_per_tile": live_slot_stats(valid),
                  "max_abs_err": err, "ms": time_ms(kernel, iters=10, reps=5),
                  "device_ms": device_ms(kernel, "rasterize_visibility", iters=10),
                  "plain_ms": time_ms(lambda: kras.rasterize_tiles_visibility_reference(
                      tri, valid, px, py, chunk=64), iters=1, reps=3)}
        k2_row.update(visibility_bound(tri, valid, px, py, peaks))
        emit({"phase": "kernel_check", "kernel": "rasterize_tiles_visibility", **k2_row})
    emit({"phase": "train_faceformer_vert",
          "config": "FaceFormerVertConfig(): wav2vec2-base, vertice_dim 15069, feature_dim 64, "
                    "4 heads of 16, period 30; synthetic FLAME 5023 / 9976 with 68 landmarks; "
                    "FAN and head at seeded random init; renders at 224^2",
          "batch": B, "frames": T, "lr": lr, "setup_s": setup_s, "cli_runs": runs,
          "k1_shape": k1_shape, "launches_per_step": per_step[0], "losses": losses,
          "step_s_all": step_s, "step_s_median_after_first": statistics.median(step_s[1:]),
          "peak_allocated_gib": peak_gib,
          "device_busy_ms": None if prof is None else prof["device_busy_ms"],
          "device_idle_share": None if prof is None else prof["device_idle_share"],
          "k3_device_ms": [r["device_ms"] for r in k3_rows],
          "k3_backward_device_ms": [r["backward_device_ms"] for r in k3_grads],
          "k2_device_ms_emo_cls_launch": k2_row["device_ms"],
          "train_faceformer_landmark_step_card_vs_cpu": landmark_step})
    return {"launches": main["launches"], "k1_shape": k1_shape, "k3_rows": k3_rows,
            "k3_grads": k3_grads, "k2_row": k2_row}


def _prior_draws(state, B, seed):
    """Explicit draws of one prior step (dropout masks, times, noise, keep
    masks) from a CPU generator, on the CPU."""
    import torch

    g = torch.Generator().manual_seed(seed)
    prior = state.prior
    return {"dropout": state.brain.dropout_masks(B, g),
            "times": torch.randint(0, prior.scheduler.num_timesteps, (B,), generator=g),
            "noise": torch.randn((B, 1, prior.net.dim), generator=g),
            "brain_keep": torch.rand((B, 1, 1), generator=g) >= prior.text_cond_drop_prob,
            "image_keep": torch.rand((B, 1, 1), generator=g) >= prior.image_cond_drop_prob}


def prior_update_card_vs_cpu(before, pair, lr: float) -> dict:
    """Holds the prior step's update (clip, then AdamW with decay on one of
    its two groups) on the card to the CPU's, weight by weight: where the
    CPU's clipped |g| >= 1e-4, Adam's first step is lr * g / (|g| + 1e-8)
    whatever the gradient's rounding, so the two updates agree to 1e-3 * lr
    plus the rounding of the weight itself (4 fp32 ulps of |w|); a skipped
    update or a decay on the wrong group (lr * 1e-2 * |w|, 1e-6 on a norm
    scale of 1) exceeds that. Also holds the clipped gradients' global norm
    (1.0 where the clip acted) to 1e-5 relative."""
    import torch

    ulp = torch.finfo(torch.float32).eps
    worst, worst_k, n = -math.inf, None, 0
    norms = {}
    for d in ("cuda", "cpu"):
        grads = [t.grad.detach().double().cpu() for t in pair[d][1].values() if t.grad is not None]
        norms[d] = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])))
    for k, tc in pair["cpu"][1].items():
        well = tc.grad.abs() >= 1e-4
        if not bool(well.any()):
            continue
        u = {d: pair[d][1][k].detach().cpu().double() - before[d][k].double() for d in before}
        excess = ((u["cuda"] - u["cpu"]).abs()
                  - (1e-3 * lr + 4 * ulp * before["cpu"][k].double().abs()))[well]
        n += int(well.sum())
        if float(excess.max()) > worst:
            worst, worst_k = float(excess.max()), k
    norm_rel = abs(norms["cuda"] - norms["cpu"]) / norms["cpu"]
    check(worst <= 0.0 and n > 0 and norm_rel < 1e-5,
          f"the prior step's update, card vs CPU: worst excess over the tolerance {worst} "
          f"({worst_k}, {n} weights with |g| >= 1e-4); clipped gradient norms {norms}")
    return {"weights_with_grad_ge_1e-4": n, "worst_excess_over_tol": worst, "worst_tensor": worst_k,
            "tol": "1e-3 * lr + 4 ulp(|w|)", "clipped_grad_norm": norms,
            "clipped_grad_norm_rel_diff": norm_rel}


def phase_train_prior():
    """`train-prior`'s training at full width (PriorTrainingConfig(): B=256,
    in 768, depth 6, 8 heads of 64, brain hidden 4096, 100 timesteps): the
    median step seconds of 5 after a warm-up; one step at B=16 on the card
    against the CPU with the same explicit draws; then the `train-prior`
    command for 4 steps with validation every 2 and a checkpoint
    directory, and again with --resume, which continues from step 4."""
    import contextlib
    import io
    import tempfile

    import torch

    from avi_talking_tpu_torch.cli import main as cli_main
    from avi_talking_tpu_torch.train.driver import (
        PriorTrainingConfig, build_state, step_generator, synthetic_batches)
    from avi_talking_tpu_torch.train.prior import PriorTrainer

    cfg = PriorTrainingConfig()
    dev = torch.device("cuda")
    state = build_state(cfg, seed=0, device=dev)
    trainer = PriorTrainer()
    losses, step_s = [], []
    for i, b in enumerate(synthetic_batches(cfg.batch_size, 6, cfg.in_dim, cfg.clip_size)):
        voxel, style = (torch.from_numpy(b[k]).to(dev) for k in ("voxel", "style_target"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(state, voxel, style, 0.006,
                                     generator=step_generator(dev, 0, i))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    check(all(math.isfinite(x) for x in losses), f"prior training losses {losses}")
    del state

    B = 16
    b = next(synthetic_batches(B, 1, cfg.in_dim, cfg.clip_size, seed=3))
    # max_lr / div_factor: the schedule's rate at count 0 is 1e-4, the
    # learning rate of the other training steps' card-vs-CPU checks
    check_cfg = dataclasses.replace(cfg, max_lr=2.5e-3)
    pair, metrics, before, lrs, draws = {}, {}, {}, {}, None
    for d in ("cuda", "cpu"):
        st = build_state(check_cfg, seed=1, device=torch.device(d))
        if draws is None:
            draws = _prior_draws(st, B, seed=4)
        moved = {k: ([m.to(d) for m in v] if k == "dropout" else v.to(d)) for k, v in draws.items()}
        named = {**{"brain." + k: t for k, t in st.brain.named_parameters()},
                 **{"prior." + k: t for k, t in st.prior.net.named_parameters()}}
        before[d] = {k: t.detach().cpu().clone() for k, t in named.items()}
        check(all(torch.equal(t, before["cuda"][k]) for k, t in before[d].items()),
              "the card's and the CPU's prior start from different weights")
        m = trainer.train_step(st, torch.from_numpy(b["voxel"]).to(d),
                               torch.from_numpy(b["style_target"]).to(d), 0.006, draws=moved)
        metrics[d] = {k: float(v) for k, v in m.items()}
        lrs[d] = [g["lr"] for g in st.optimizer.adamw.param_groups]
        pair[d] = (metrics[d]["loss"], named)
    rel = {k: abs(metrics["cuda"][k] - metrics["cpu"][k]) / max(abs(metrics["cpu"][k]), 1e-12)
           for k in ("loss", "loss_nce", "loss_prior")}
    check(all(v < 1e-4 for v in rel.values()),
          f"one prior step, card vs CPU: relative differences {rel}")
    lr = lrs["cpu"][0]
    check(lrs["cuda"] == lrs["cpu"] and all(abs(x - 1e-4) < 1e-12 for x in lrs["cpu"]),
          f"the prior step's learning rates {lrs}, not the schedule's 1e-4 at count 0")
    # the helper holds the clipped gradients (the clip scales .grad in place),
    # the weights after the step and the loss
    one_step = one_step_card_vs_cpu(pair, lr=lr, loss_tol=1e-4 * abs(metrics["cpu"]["loss"]))
    update = prior_update_card_vs_cpu(before, pair, lr)
    del pair, before

    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        args = ["train-prior", "--steps", "4", "--val-every", "2", "--ckpt-dir",
                os.path.join(tmp, "ck")]
        outs = []
        t0 = time.perf_counter()
        for extra in ([], ["--resume"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(args + extra)
            check(rc == 0, f"train-prior {' '.join(extra)} exited {rc}")
            outs.append(buf.getvalue())
        cli_s = time.perf_counter() - t0
        check("val@2" in outs[0] and "val@4" in outs[0], f"train-prior printed {outs[0]!r}")
        check("at step 4" in outs[1] and "val@6" in outs[1] and "val@8" in outs[1],
              f"train-prior --resume printed {outs[1]!r}")
        for path in ("best/state.pt", "last/state.pt"):
            check(os.path.exists(os.path.join(tmp, "ck", path)), f"train-prior wrote no {path}")
    final = [line for line in outs[1].splitlines() if line.startswith("final:")]
    emit({"phase": "train_prior", "config": "PriorTrainingConfig()", "batch": cfg.batch_size,
          "losses": losses, "step_s_all": step_s,
          "step_s_median_after_first": statistics.median(step_s[1:]),
          "gpu_vs_cpu_one_step_B16": {"metrics": metrics, "rel_diff": rel, "rtol": 1e-4,
                                      "lr": lr, **one_step, "update": update},
          "cli": "train-prior --steps 4 --val-every 2 --ckpt-dir <tmp>, then --resume",
          "cli_wall_s": cli_s, "resumed_final": final[0] if final else None})


MEAD_DATA_CLIPS = [f"{ident}_front_{emo}_level{lvl}_001"
                   for ident in ("M003", "M005", "M007", "W009", "W011", "W014")
                   for emo, lvl in (("neutral", 1), ("happy", 2), ("angry", 3))]


def _filtered_decode_s(filter_type: int, size: int = 224) -> float:
    """Seconds the port's pure-Python decoder takes to undo one size^2 RGB
    crop whose rows all carry ``filter_type`` (real encoders choose Sub /
    Up / Average / Paeth per row; the synthetic crops are all None)."""
    import numpy as np

    from avi_talking_tpu_torch.viz.pngio import _unfilter

    stride = size * 3
    rows = np.random.default_rng(filter_type).integers(0, 256, (size, stride), dtype=np.uint8)
    raw = b"".join(bytes([filter_type]) + r.tobytes() for r in rows)
    t0 = time.perf_counter()
    _unfilter(raw, size, size, 3)
    return time.perf_counter() - t0


@contextlib.contextmanager
def _patched(obj, name, wrap):
    """``obj.name`` replaced by ``wrap(obj.name)`` inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _timed_next(it, seconds: list):
    """``it``, with the host seconds of each ``next`` appended to ``seconds``."""
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        seconds.append(time.perf_counter() - t0)
        yield item


def _step_probe(record: dict, counters, seen: dict):
    """A wrapper of a trainer's ``train_step`` that records each step's
    seconds (synchronised), loss and kernel launches (the change of each
    module's ``launches`` across the step), and the input shape of the
    first wav2vec2 encoder layer."""
    import torch

    def wrap(orig):
        def train_step(self, batch, *args, **kwargs):
            model = self.model if hasattr(self, "model") else self.head
            hook = model.audio_encoder.encoder.layers[0].register_forward_pre_hook(
                lambda module, a: seen.update(encoder_input=list(a[0].shape)))
            torch.cuda.synchronize()
            before = [m.launches for m in counters]
            t0 = time.perf_counter()
            try:
                out = orig(self, batch, *args, **kwargs)
                torch.cuda.synchronize()
            finally:
                hook.remove()
            record["step_s"].append(time.perf_counter() - t0)
            record["launches"].append([m.launches - b for m, b in zip(counters, before)])
            record["losses"].append(float(out["loss"]))
            return out
        return train_step
    return wrap


def phase_train_data(kb, kba):
    """The data-backed training commands at full width on a synthetic MEAD
    tree under build/chip_smoke/ (18 clips: 6 identities x neutral level 1 /
    happy level 2 / angry level 3, 100 frames, full-width EMOCA codes, 16
    kHz wavs, 224^2 crops), each command's own steps timed and counted
    (its trainer's ``train_step`` and its batch reading wrapped):

    - `train-emote --root` at its defaults (EmoteConfig(), B=8, 64 frames,
      --val-fraction 0.2), two stages of 3 steps with a run directory: the
      split line, K1 12 a step and 12 a validation batch, the head's
      weights moved from their init, each step's batch and step seconds;
    - `train-faceformer --root` at its defaults (FaceFormerConfig(), B=16,
      T=25, conditioning on), 5 steps: K1 12 and K3 2 a step; the seconds
      of each step's batch (npys, wavs, 800 PNG decodes), FanConditioner
      (two FAN passes over 400 crops) and training step, and their shares;
      the decode of one crop under each row filter;
    - FanConditioner card vs CPU on the same B=2, T=6 crops and seed: the
      draws and ref_coeff equal, the embeddings within 1e-4 of their
      largest (TF32 off); then one train-faceformer step at B=2, T=6 on that
      conditioned batch, card vs CPU, by `one_step_card_vs_cpu`;
    - `train-prior --json-dir experiments/json_dir --wav-dir
      experiments/wav_dir` (CLIP ViT-L/14 text tower, B=256 by wrap-around)
      for 4 steps with validation, then `train-prior --root` (generated
      captions) for 2 steps: the corpus and split lines; the step stepped
      directly (featurize + step); `featurize` card vs CPU on 8 captions:
      voxel and style within 1e-4 of their largest.

    No kernel runs on the prior's route. The phase prints its seconds."""
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from avi_talking_tpu_torch.cli import main as cli_main
    from avi_talking_tpu_torch.cli import train as ff_cli
    from avi_talking_tpu_torch.cli.train_emote import build_head
    from avi_talking_tpu_torch.cli.train_prior import build_featurizer
    from avi_talking_tpu_torch.data import train_batches
    from avi_talking_tpu_torch.data.prior_corpus import load_corpus_items, prior_corpus_batches
    from avi_talking_tpu_torch.infra.checkpoint import restore_checkpoint
    from avi_talking_tpu_torch.models.faceformer import FaceFormerConfig
    from avi_talking_tpu_torch.train.driver import PriorTrainingConfig, build_state, step_generator
    from avi_talking_tpu_torch.train.faceformer_trainer import FaceFormerTrainer
    from avi_talking_tpu_torch.train.optim import adamw
    from avi_talking_tpu_torch.train.prior import PriorTrainer
    from avi_talking_tpu_torch.train.talking_head import TalkingHeadTrainer
    from avi_talking_tpu_torch.viz.pngio import read_image_normalized

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    root = os.path.join(out_dir, "mead_data")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    _write_mead_tree(root, len(MEAD_DATA_CLIPS), 100, seed=21, names=MEAD_DATA_CLIPS, crop_size=224)
    tree_s = time.perf_counter() - t0

    def run(argv):
        buf, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = cli_main(argv)
        torch.cuda.synchronize()
        check(rc == 0, f"{argv[0]} exited {rc}: {err.getvalue()[-2000:]}")
        return buf.getvalue(), time.perf_counter() - t0

    def line(out, prefix):
        found = [ln for ln in out.splitlines() if ln.startswith(prefix)]
        check(len(found) == 1, f"expected one {prefix!r} line in {out!r}")
        return found[0]

    def median_after_first(xs):
        return statistics.median(xs[1:])

    # train-emote --root: the command, its steps probed
    B, T = 8, 64
    n_val = int(round(0.2 * len(MEAD_DATA_CLIPS)))
    emote = {"data_s": [], "step_s": [], "launches": [], "losses": []}

    def timed_emote_batches(orig):
        def emote_batches(builder, batch_size, *args, epochs=None, **kwargs):
            it = orig(builder, batch_size, *args, epochs=epochs, **kwargs)
            return _timed_next(it, emote["data_s"]) if epochs is None else it  # the training stream
        return emote_batches

    with tempfile.TemporaryDirectory(dir=out_dir) as tmp, \
            _patched(train_batches, "emote_batches", timed_emote_batches), \
            _patched(TalkingHeadTrainer, "train_step", _step_probe(emote, [kb], {})):
        kb.launches = 0
        out, emote_cli_s = run(["train-emote", "--root", root, "--steps", "3", "--val-every", "3",
                                "--val-fraction", "0.2", "--run-dir", os.path.join(tmp, "run")])
        emote_cli_launches = kb.launches
        last = restore_checkpoint(os.path.join(tmp, "run", "checkpoints", "last"),
                                  map_location="cpu")["params"]
    split_line = line(out, "data root:")
    check(split_line == f"data root: {len(MEAD_DATA_CLIPS) - n_val} train / {n_val} val clips",
          f"train-emote --root printed {split_line!r}")
    check(emote["launches"] == [[12]] * 6, f"train-emote --root's steps launched K1 "
          f"{emote['launches']} times, not 12 each")
    # and one validation of one batch (the n_val clips) after each stage's third step
    check(emote_cli_launches == 12 * 2 * (3 + 1),
          f"train-emote --root launched K1 {emote_cli_launches} times, not {12 * 2 * 4}")
    check(all(math.isfinite(x) for x in emote["losses"]), f"losses {emote['losses']}")
    init = build_head(tiny=False, seed=0, device=torch.device("cpu")).state_dict()
    moved = max(float((last[k].float() - v.float()).abs().max()) for k, v in init.items()
                if v.is_floating_point())
    check(math.isfinite(moved) and moved > 0, f"train-emote --root moved the head by {moved}")
    del last, init

    # train-faceformer --root: the command, its batches, conditioning and steps probed
    steps = 5
    ff = {"data_s": [], "condition_s": [], "step_s": [], "launches": [], "losses": []}
    seen = {}

    def timed_source(orig):
        def mead_source(*args, **kwargs):
            batches, conditioner = orig(*args, **kwargs)
            return _timed_next(batches, ff["data_s"]), conditioner
        return mead_source

    def timed_conditioned(orig):
        def conditioned(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            ff["condition_s"].append(time.perf_counter() - t0)
            return out
        return conditioned

    torch.cuda.reset_peak_memory_stats()
    with _patched(ff_cli, "mead_source", timed_source), \
            _patched(ff_cli, "conditioned", timed_conditioned), \
            _patched(FaceFormerTrainer, "train_step", _step_probe(ff, [kb, kba], seen)):
        kb.launches = kba.launches = 0
        out, ff_cli_s = run(["train-faceformer", "--root", root, "--steps", str(steps)])
        ff_cli_launches = {"keybias_attention": kb.launches, "fused_bias_attention": kba.launches}
    ff_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(ff_cli_launches == {"keybias_attention": 12 * steps, "fused_bias_attention": 2 * steps},
          f"train-faceformer --root's {steps} steps launched {ff_cli_launches}")
    check(ff["launches"] == [[12, 2]] * steps, f"train-faceformer --root's steps launched "
          f"{ff['launches']}, not K1 12 and K3 2 each")
    ff_final = line(out, "final:")
    check(math.isfinite(float(ff_final.split("'loss': ")[1].rstrip("}"))), ff_final)
    # the command reads and conditions one batch before its first step
    check(len(ff["data_s"]) == len(ff["condition_s"]) == steps + 1,
          f"{len(ff['data_s'])} batches read for {steps} steps")
    per_step = {"data_s": ff["data_s"][1:], "condition_s": ff["condition_s"][1:],
                "step_s": ff["step_s"]}
    med = {k: median_after_first(v) for k, v in per_step.items()}
    total = sum(med.values())
    cfg = FaceFormerConfig()
    heads = cfg.wav2vec2.num_attention_heads
    ff_k1_shape = [16, heads, seen["encoder_input"][1], seen["encoder_input"][1],
                   cfg.wav2vec2.hidden_size // heads]
    crops = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(root) for f in fs
                   if f.endswith(".png"))[:100]
    t0 = time.perf_counter()
    for p in crops:
        read_image_normalized(p)
    decode_s = (time.perf_counter() - t0) / len(crops)

    # FanConditioner, then one conditioned step, card vs CPU
    small = types.SimpleNamespace(root=root, seq_length=6, batch_size=2, seed=3,
                                  fan_checkpoint=None)
    cond_out, states, raw = {}, {}, {}
    for dev in ("cuda", "cpu"):
        with contextlib.redirect_stderr(io.StringIO()):
            source, cond = ff_cli.mead_source(small, cfg, torch.device(dev))
        raw[dev] = next(source)
        cond_out[dev] = {k: v.cpu() for k, v in
                         ff_cli.conditioned(raw[dev], cfg, cond, torch.device(dev)).items()}
        states[dev] = cond._rng.bit_generator.state
    check(np.array_equal(raw["cuda"]["img"], raw["cpu"]["img"]), "the two sides read other crops")
    check(states["cuda"] == states["cpu"], "FanConditioner drew differently on the card")
    check(torch.equal(cond_out["cuda"]["ref_coeff"], cond_out["cpu"]["ref_coeff"]),
          "ref_coeff differs card vs CPU")
    fan_rel = {k: float((cond_out["cuda"][k] - cond_out["cpu"][k]).abs().max()
                        / cond_out["cpu"][k].abs().max()) for k in ("eye_embed", "emo_embed")}
    check(all(v < 1e-4 for v in fan_rel.values()),
          f"FanConditioner card vs CPU: {fan_rel} of the largest (limit 1e-4)")
    pair = {}
    for dev in ("cuda", "cpu"):
        m = _faceformer_model(cfg, seed=2, device=dev)
        tr = FaceFormerTrainer(model=m, optimizer=adamw(m.parameters(), 1e-4))
        loss = float(tr.train_step({k: v.to(dev) for k, v in cond_out["cuda"].items()})["loss"])
        pair[dev] = (loss, dict(m.named_parameters()))
    one_step = one_step_card_vs_cpu(pair, lr=1e-4, loss_tol=1e-4 * max(1.0, abs(pair["cpu"][0])))
    del pair

    # train-prior on the caption corpus: both routes, the step, featurize card vs CPU
    json_dir = os.path.join(HERE, "experiments", "json_dir")
    wav_dir = os.path.join(HERE, "experiments", "wav_dir")
    out, prior_json_s = run(["train-prior", "--json-dir", json_dir, "--wav-dir", wav_dir,
                             "--steps", "4", "--val-every", "2", "--val-fraction", "0.25"])
    prior_json = [line(out, "corpus:"), line(out, "split:")]
    check(prior_json == ["corpus: 4 caption pairs", "split: 3 train / 1 val"],
          f"train-prior --json-dir printed {prior_json}")
    check("val@2" in out and "val@4" in out, f"train-prior --json-dir printed {out!r}")
    out, prior_root_s = run(["train-prior", "--root", root, "--steps", "2"])
    n = len(MEAD_DATA_CLIPS)
    prior_root = [line(out, "corpus:"), line(out, "split:")]
    check(prior_root == [f"corpus: {n} caption pairs", f"split: {n} train / 0 val"],
          f"train-prior --root printed {prior_root}")
    pcfg = PriorTrainingConfig()
    feats = {dev: build_featurizer(False, pcfg.clip_size, torch.device(dev))
             for dev in ("cuda", "cpu")}
    items = load_corpus_items(json_dir=json_dir, wav_dir=wav_dir)
    state = build_state(pcfg, seed=0, device=cuda)
    prior = {"featurize_s": [], "step_s": [], "losses": []}
    stream = prior_corpus_batches(items, feats["cuda"], pcfg.batch_size, 6)
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = next(stream)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = PriorTrainer().train_step(state, b["voxel"], b["style_target"], 0.006,
                                            generator=step_generator(cuda, 0, i))
        torch.cuda.synchronize()
        prior["featurize_s"].append(t1 - t0)
        prior["step_s"].append(time.perf_counter() - t1)
        prior["losses"].append(float(metrics["loss"]))
    check(all(math.isfinite(x) for x in prior["losses"]), f"prior losses {prior['losses']}")
    del state, stream
    tok = feats["cpu"].tokenize_corpus(load_corpus_items(mead_root=root)[:8])
    f = {dev: {k: v.cpu() for k, v in feats[dev].featurize(tok["ids"], tok["cond"]).items()}
         for dev in ("cuda", "cpu")}
    feat_rel = {k: float((f["cuda"][k] - f["cpu"][k]).abs().max() / f["cpu"][k].abs().max())
                for k in ("voxel", "style_target")}
    check(all(v < 1e-4 for v in feat_rel.values()),
          f"featurize card vs CPU: {feat_rel} of the largest (limit 1e-4)")
    del feats

    emit({"phase": "train_data", "tree": {"clips": n, "frames": 100, "crop": 224,
                                          "seconds": tree_s},
          "train_emote_root": {
              "cli": "train-emote --root <tree> --steps 3 --val-every 3 --val-fraction 0.2 "
                     "--run-dir <tmp>", "cli_wall_s": emote_cli_s, "split": split_line,
              "cli_k1_launches": emote_cli_launches, "head_moved_max_abs": moved,
              "batch": B, "frames": T, "k1_launches_per_step": [n for n, in emote["launches"]],
              "losses": emote["losses"], "data_s_all": emote["data_s"],
              "step_s_all": emote["step_s"],
              "data_s_median_after_first": median_after_first(emote["data_s"]),
              "step_s_median_after_first": median_after_first(emote["step_s"])},
          "train_faceformer_root": {
              "cli": f"train-faceformer --root <tree> --steps {steps}", "cli_wall_s": ff_cli_s,
              "cli_launches": ff_cli_launches, "final": ff_final, "batch": 16, "seq_length": 25,
              "k1_shape": ff_k1_shape, "launches_per_step": ff["launches"],
              "losses": ff["losses"], "data_s_all": per_step["data_s"],
              "condition_s_all": per_step["condition_s"], "step_s_all": per_step["step_s"],
              "median_after_first": med, "total_s": total,
              "share": {k: v / total for k, v in med.items()},
              "pngs_per_step": 2 * 16 * 25, "png_decode_s_per_crop": decode_s,
              "unfilter_s_per_crop": {name: _filtered_decode_s(ft) for name, ft in (
                  ("none", 0), ("sub", 1), ("up", 2), ("average", 3), ("paeth", 4))},
              "peak_allocated_gib": ff_peak_gib},
          "fan_conditioner_card_vs_cpu_B2_T6": {"rel_to_largest": fan_rel, "limit": 1e-4,
                                                 "draws_equal": True},
          "gpu_vs_cpu_one_step_B2_T6": one_step,
          "train_prior_corpus": {
              "json_dir": prior_json, "json_dir_cli_wall_s": prior_json_s,
              "root": prior_root, "root_cli_wall_s": prior_root_s,
              "batch": pcfg.batch_size, "losses": prior["losses"],
              "featurize_s_all": prior["featurize_s"], "step_s_all": prior["step_s"],
              "featurize_s_median_after_first": median_after_first(prior["featurize_s"]),
              "step_s_median_after_first": median_after_first(prior["step_s"]),
              "featurize_card_vs_cpu_8_captions": {"rel_to_largest": feat_rel, "limit": 1e-4}},
          "seconds": time.perf_counter() - t_phase})
    return {"emote_launches": emote_cli_launches, "ff_launches": ff_cli_launches,
            "ff_k1_shape": ff_k1_shape}


def phase_generate(pipe, kb):
    import numpy as np

    wav = synthetic_wav(8.0, seed=1)
    instruction = "A fairly angry man speaks with brow fairly down"
    kb.launches = 0
    out = pipe.generate(wav, instruction, seed=0)
    launches = kb.launches
    check(launches == 12, f"generate launched keybias_attention {launches} times, not 12")
    shapes = {k: list(v.shape) for k, v in out.items()}
    check(out["exp"].shape == (200, 50) and out["jaw"].shape == (200, 3)
          and out["vertices"].shape == (200, 5023, 3), f"generate shapes {shapes}")
    check(all(np.isfinite(v).all() for v in out.values()), "generate: non-finite output")
    again = pipe.generate(wav, instruction, seed=0)
    repeat_diff = max(float(np.abs(again[k] - out[k]).max())
                      for k in ("exp", "jaw", "vertices", "style_emb"))
    check(np.array_equal(again["style_emb"], out["style_emb"]) and repeat_diff <= 1e-6,
          f"same seed gave another output (max |d| {repeat_diff})")
    other = pipe.generate(wav, instruction, seed=1)
    check(not np.allclose(other["style_emb"], out["style_emb"]), "seed does not change the style")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        pipe.generate(wav, instruction, seed=0)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    emit({"phase": "generate", "audio_s": 8.0, "shapes": shapes, "finite": True,
          "keybias_launches": launches, "same_seed_max_abs_diff": repeat_diff,
          "wall_s_median": wall, "wall_s_all": walls, "s_per_audio_s": wall / 8.0})
    return launches, out


def phase_generate_batch(pipe, kb):
    import numpy as np

    seconds = [3.0, 3.5, 8.0, 9.0, 16.0, 19.0]
    wavs = [synthetic_wav(s, seed=10 + i) for i, s in enumerate(seconds)]
    instructions = ["a happy person speaks", "a sad person", "an angry man shouts",
                    "calm and neutral", "surprised woman", "a fearful voice"]
    st = {}
    kb.launches = 0
    outs = pipe.generate_batch(wavs, instructions, seed=0, stage_times=st)
    launches = kb.launches
    check(launches == 36, f"generate_batch launched keybias_attention {launches} times, not 36")
    frames = []
    for s, o in zip(seconds, outs):
        T = o["frames"].shape[0]
        frames.append(T)
        check(T == math.ceil(int(s * 25) / 8) * 8, f"{s} s clip framed to {T}")
        check(o["exp"].shape == (T, 50) and o["jaw"].shape == (T, 3)
              and o["vertices"].shape == (T, 5023, 3), f"{s} s clip shapes")
        check(all(np.isfinite(v).all() for v in o.values()), f"{s} s clip: non-finite")
    buckets = {}
    for T in frames:
        b = min(b for b in (64, 128, 256, 512) if T <= b)
        buckets[b] = buckets.get(b, 0) + 1
    check(buckets == {128: 2, 256: 2, 512: 2}, f"bucket occupancy {buckets}")
    emit({"phase": "generate_batch", "requests_s": seconds, "frames": frames,
          "buckets": buckets, "finite": True,
          "keybias_launches": launches, "stage_times_ms": st})
    return launches


def phase_gpu_vs_cpu(pipe):
    import numpy as np

    from avi_talking_tpu_torch.core.assets import synthetic_assets
    from avi_talking_tpu_torch.pipeline import AviTalkingPipeline, PipelineConfig

    tol = 1e-3  # fp32 on both (TF32 off); 100 prior steps and 12+1+1 layers reorder sums
    cpu = AviTalkingPipeline.random_init(
        PipelineConfig(), synthetic_assets(num_vertices=5023, n_shape=300, n_exp=50,
                                           num_faces=9976), seed=1, device="cpu")
    cpu.load_state_dict({k: {n: t.cpu() for n, t in sd.items()}
                         for k, sd in pipe.state_dict().items()})
    rng = np.random.default_rng(7)
    noise = {"init": rng.standard_normal((1, 1, 128)).astype(np.float32),
             "steps": rng.standard_normal((100, 1, 1, 128)).astype(np.float32)}
    wav = synthetic_wav(4.0, seed=2)
    instruction = "a joyful person speaks with lifted cheek"
    g = pipe.generate(wav, instruction, noise=noise)
    t0 = time.perf_counter()
    c = cpu.generate(wav, instruction, noise=noise)
    cpu_s = time.perf_counter() - t0
    errs = {k: float(np.abs(g[k] - c[k]).max()) for k in ("style_emb", "exp", "jaw", "vertices")}
    scale = {k: float(np.abs(c[k]).max()) for k in errs}
    emit({"phase": "gpu_vs_cpu", "audio_s": 4.0, "max_abs_err": errs, "max_abs_value": scale,
          "tol": tol, "cpu_wall_s": cpu_s})
    for k, e in errs.items():
        check(e < tol, f"GPU vs CPU {k}: max |d| {e} >= {tol}")


def phase_visibility(verts, faces, peaks, ptxas):
    """K2 against its plain version, bit for bit, at visibility_cases'
    three shapes, with its time (CUDA events around the wrapper, and the
    kernel's own device time under torch.profiler), both bounds, the live
    slots per tile and the launch's blocks."""
    import torch

    from avi_talking_tpu_torch.ops.kernels import rasterize as kras

    rows = []
    for name, tri, valid, px, py, frames, n_faces in visibility_cases(verts, faces):
        z, s = kras.rasterize_tiles_visibility(tri, valid, px, py)
        torch.cuda.synchronize()
        rz, rs = kras.rasterize_tiles_visibility_reference(tri, valid, px, py)
        err = float((z - rz).abs().max())
        check(torch.equal(s, rs) and torch.equal(z, rz),
              f"K2 {name}: not bit-equal to the plain version ({int((s != rs).sum())} slots "
              f"differ, max |dz| {err})")

        def kernel():
            return kras.rasterize_tiles_visibility(tri, valid, px, py)

        row = {"case": name, "shape": list(tri.shape[:2]) + [px.shape[1]],
               "frames": frames, "faces": n_faces, "valid_slots": int(valid.sum()),
               "slots": valid.numel(), "live_slots_per_tile": live_slot_stats(valid),
               "launch": visibility_launch(tri.shape[0], px.shape[1], ptxas),
               "covered_pixels": int((s >= 0).sum()),
               "max_abs_err": err, "slot_mismatches": int((s != rs).sum()),
               "ms": time_ms(kernel, iters=10, reps=5),
               "device_ms": device_ms(kernel, "rasterize_visibility"),
               "plain_ms": time_ms(lambda: kras.rasterize_tiles_visibility_reference(
                   tri, valid, px, py), iters=2, reps=3)}
        row.update(visibility_bound(tri, valid, px, py, peaks))
        rows.append(row)
        emit({"phase": "kernel_check", "kernel": "rasterize_tiles_visibility", **row})
    return rows


def phase_render(verts, faces):
    """The 8 s clip's 200 frames through FlameVisualizer.visualize_verts
    (13 chunks of 16 frames, so 13 K2 launches), repeatability, the wall
    time (median of 3), K2's device time in one render_verts; then the
    kernel route against the dense plain rasterizer on the head mesh."""
    import numpy as np
    import torch

    from avi_talking_tpu_torch.ops.kernels import rasterize as kras
    from avi_talking_tpu_torch.viz import FlameVisualizer, compute_vertex_normals, rasterize_auto

    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    viz = FlameVisualizer(faces, 256)
    kras.launches = 0
    t0 = time.perf_counter()
    path = viz.visualize_verts(verts, os.path.join(out_dir, "render.mp4"))
    walls = [time.perf_counter() - t0]
    launches = kras.launches
    check(launches == 13, f"the 200-frame render launched K2 {launches} times, not 13")
    if path.endswith(".mp4"):
        check(os.path.getsize(path) > 0, "empty mp4")
    else:
        check(len(os.listdir(path)) == 200, "PNG directory without 200 frames")
    frames = viz.render_verts(verts)
    again = viz.render_verts(verts)
    check(frames.shape == (200, 256, 256, 3) and np.isfinite(frames).all(),
          f"render frames {frames.shape}, finite {np.isfinite(frames).all()}")
    covered = float((frames != 0).any(-1).mean())
    check(covered > 0.05, f"the mesh covers {covered} of the frame")
    check(np.array_equal(frames, again), "the same vertices rendered twice differ")
    render_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        viz.render_verts(verts)
        render_s.append(time.perf_counter() - t0)
    k2_ms = device_ms(lambda: viz.render_verts(verts), "rasterize_visibility", iters=3)
    for _ in range(2):
        t0 = time.perf_counter()
        viz.visualize_verts(verts, os.path.join(out_dir, "render.mp4"))
        walls.append(time.perf_counter() - t0)

    hv, hf = head_mesh()
    head = torch.from_numpy(head_frames(hv, 2)).cuda()
    hf = torch.from_numpy(hf).cuda()
    normals = compute_vertex_normals(head, hf)
    before = kras.launches
    img_k, m_k = rasterize_auto(head, hf, normals, 256, 256)
    head_launches = kras.launches - before
    img_d, m_d = rasterize_auto(head, hf, normals, 256, 256, backend="dense")
    torch.cuda.synchronize()
    head_err = float((img_k - img_d).abs().max())
    check(head_launches == 1, f"rasterize_auto on the head mesh launched K2 {head_launches} times")
    check(torch.equal(m_k, m_d), f"head mesh: {int((m_k != m_d).sum())} mask pixels differ")
    check(head_err <= 1e-5, f"head mesh: kernel route vs dense max |d| {head_err}")
    emit({"phase": "render", "frames": list(frames.shape), "finite": True,
          "covered_share": covered, "k2_launches": launches, "repeat_identical": True,
          "output": "mp4" if path.endswith(".mp4") else "png_dir",
          "path": os.path.relpath(path, HERE),
          "visualize_wall_s_median": statistics.median(walls), "visualize_wall_s_all": walls,
          "render_verts_s_median": statistics.median(render_s), "render_verts_s_all": render_s,
          "k2_device_ms_per_render": k2_ms,
          "head_mesh": {"faces": int(hf.shape[0]), "k2_launches": head_launches,
                        "mask_equal_dense": True, "max_abs_err_vs_dense": head_err,
                        "covered_pixels": int(m_k.sum())}})
    return launches


def phase_render_gpu_vs_cpu():
    """Four head-mesh frames (moved into model space so the visualizer's
    camera frames them) through FlameVisualizer on the card (kernel route)
    and on the CPU (plain binned route)."""
    import numpy as np

    from avi_talking_tpu_torch.viz import FlameVisualizer

    hv, hf = head_mesh()
    ndc = head_frames(hv, 4)
    verts = np.stack([ndc[..., 0] / 8, -ndc[..., 1] / 8 + 0.01, -ndc[..., 2] / 8], axis=-1)
    g = FlameVisualizer(hf, 256).render_verts(verts)
    t0 = time.perf_counter()
    c = FlameVisualizer(hf, 256, device="cpu").render_verts(verts)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(g - c).max())
    mask_diff = int(((g != 0).any(-1) != (c != 0).any(-1)).sum())
    emit({"phase": "render_gpu_vs_cpu", "frames": 4, "faces": int(hf.shape[0]),
          "mask_pixels_differing": mask_diff, "max_abs_err": err, "tol": 1e-5,
          "cpu_wall_s": cpu_s})
    check(mask_diff == 0, f"render GPU vs CPU: {mask_diff} mask pixels differ")
    check(err <= 1e-5, f"render GPU vs CPU: max |d| {err}")


class _RecordingPipeline:
    """Forwards the server's generate_batch calls to the pipeline and keeps
    each call's micro-batch and outputs, so the check can run the same
    padded micro-batch again."""

    def __init__(self, pipe):
        import threading

        self.pipe, self.cfg = pipe, pipe.cfg
        self.calls = []
        self._lock = threading.Lock()

    def generate_batch(self, wavs, instructions, **kw):
        outs = self.pipe.generate_batch(wavs, instructions, **kw)
        with self._lock:
            self.calls.append((list(wavs), list(instructions), dict(kw), outs))
        return outs


def phase_serve(pipe, kb):
    """The fixture corpus through InferenceServer at max_batch 4, submitted
    and collected as `cli serve` does it, three rounds (the first is cold);
    each result against generate_batch on the same padded micro-batch."""
    import numpy as np

    from avi_talking_tpu_torch.data import CaptionDataset
    from avi_talking_tpu_torch.pipeline.server import InferenceServer, ServingConfig

    ds = CaptionDataset(os.path.join(HERE, "experiments", "json_dir"),
                        os.path.join(HERE, "experiments", "wav_dir"))
    requests = [(item.wav_path, caption) for item in ds for caption in item.captions]
    check(len(requests) >= 4, f"fixture corpus has {len(requests)} requests")
    rec = _RecordingPipeline(pipe)
    scfg = ServingConfig(max_batch=4, max_wait_ms=5.0, batch_buckets=(1, 2, 4),
                         length_buckets=(64, 128, 256, 512))
    rounds, results = [], []
    kb.launches = 0
    with InferenceServer(rec, scfg) as server:
        for r in range(3):
            t0 = time.perf_counter()
            futs = [(wav, cap, server.submit(wav, cap, seed=0)) for wav, cap in requests]
            results += [(wav, cap, f.result(timeout=600)) for wav, cap, f in futs]
            rounds.append({"wall_s": time.perf_counter() - t0, **server.latency_percentiles(),
                           "stage_breakdown_ms": server.stage_breakdown(),
                           "batch_sizes": list(server.stats["batch_size"])})
            server.clear_stats()
    launches = kb.launches
    rerun, worst = {}, 0.0
    for wav, cap, out in results:
        hits = [(ci, j) for ci, call in enumerate(rec.calls) for j, o in enumerate(call[3])
                if o is out]
        check(len(hits) == 1, "a served result is not one row of one micro-batch")
        ci, j = hits[0]
        wavs, instrs, kw, _ = rec.calls[ci]
        check(wavs[j] == wav and instrs[j] == cap, "a result came back to another request")
        T = out["exp"].shape[0]
        check(out["exp"].shape == (T, pipe.cfg.emote.n_exp) and out["jaw"].shape == (T, 3)
              and out["style_emb"].shape == (pipe.cfg.clip_size,) and "vertices" not in out,
              f"served shapes {[(k, v.shape) for k, v in out.items()]}")
        check(all(np.isfinite(v).all() for v in out.values()), "served output not finite")
        if ci not in rerun:
            kw = {k: v for k, v in kw.items() if k != "stage_times"}
            rerun[ci] = pipe.generate_batch(wavs, instrs, **kw)
        ref = rerun[ci][j]
        worst = max(worst, *(float(np.abs(out[k] - ref[k]).max())
                              for k in ("exp", "jaw", "style_emb")))
    check(worst <= 1e-4, f"served results vs generate_batch: max |d| {worst}")
    emit({"phase": "serve", "requests_per_round": len(requests), "rounds": rounds,
          "micro_batches": len(rec.calls), "padded_sizes": sorted({len(c[0]) for c in rec.calls}),
          "max_abs_err_vs_generate_batch": worst, "tol": 1e-4, "keybias_launches": launches})


def attention_bound_bf16(B, H, T, S, d, peaks):
    """K1's least time on bfloat16 inputs: 4*B*H*T*S*d operations (q.k^T and
    p.v) over the dense bf16 tensor-core peak, or q, k, v, out and the (B, S)
    key bias read or written once in bfloat16 over the memory rate, whichever
    is larger."""
    ops = 4 * B * H * T * S * d
    nbytes = 2 * B * H * (2 * T + 2 * S) * d + 2 * B * S
    t_ops, t_bytes = ops / peaks[3], nbytes / peaks[1]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def phase_kernels_bf16(peaks):
    """K1's bfloat16 entry against its plain version on the card at the
    generate path's shapes (bfloat16 q, k, v and key bias, as wav2vec2 sends
    them under --bf16). Limit (``kb.bf16_disagreement``, which derives it):
    each element within 2^-7 |ref| + 2^-9 max|ref| (one bfloat16 step of the
    output, since both sides round P and the output from float32 values that
    differ only in summation order and expf's last bits, plus a share for
    flipped P), and rms(out - ref) within 2^-11 rms(ref) plus one element's
    step over the N elements (few elements flip; a kernel that mis-normalises
    P by 0.4% or rounds the unnormalised exponentials reads 2^-7.6 or 2^-8.4
    rms(ref)). With its time (CUDA events around the
    wrapper, the kernel's device time under torch.profiler), the plain
    version's, scaled_dot_product_attention's at bfloat16 with the same
    float mask, and the bound at the bf16 peak."""
    import torch
    import torch.nn.functional as F

    from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb

    g = torch.Generator(device="cuda").manual_seed(1)
    cases = [
        ("generate", 1, 12, 200, 200, 64, (200,)),
        ("batch_512", 2, 12, 512, 512, 64, (512, 300)),
        ("ragged_333", 1, 12, 333, 333, 64, (333,)),
        ("generate_600", 1, 12, 600, 600, 64, (600,)),
    ]
    rows = []
    for name, B, H, T, S, d, lens in cases:
        q = (torch.randn(B, H, T, d, device="cuda", generator=g) * d ** -0.5).bfloat16()
        k = torch.randn(B, H, S, d, device="cuda", generator=g).bfloat16()
        v = torch.randn(B, H, S, d, device="cuda", generator=g).bfloat16()
        valid = torch.tensor(lens, device="cuda")
        bias = torch.where(torch.arange(S, device="cuda")[None] < valid[:, None], 0.0,
                           -1e9).bfloat16()
        before = kb.launches
        out = kb.keybias_attention(q, k, v, bias)
        torch.cuda.synchronize()
        check(out.dtype == torch.bfloat16 and kb.launches == before,
              "the bfloat16 inputs took the float32 kernel")
        ref = kb.keybias_attention_reference(q, k, v, bias)
        dis = kb.bf16_disagreement(out, ref)
        check(math.isfinite(dis["max_abs"]) and dis["worst"] <= 1.0 and dis["rms_worst"] <= 1.0,
              f"keybias_attention bf16 {name}: {dis} past the limit")
        mask = bias[:, None, None, :]

        def kernel():
            return kb.keybias_attention(q, k, v, bias)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)

        row = {
            "case": name, "shape": [B, H, T, S, d], "dtype": "bfloat16",
            "max_abs_err": dis["max_abs"], "limit_share": dis["worst"],
            "rms_limit_share": dis["rms_worst"], "rms_rel": dis["rms_rel"],
            "flipped": dis["flipped"], "ms": time_ms(kernel),
            "device_ms": device_ms(kernel, "keybias_attention_bf16_kernel"),
            "plain_ms": time_ms(lambda: kb.keybias_attention_reference(q, k, v, bias)),
            "library_ms": time_ms(library),
            "library_device_ms": device_ms(library),
        }
        row["bound_ms"], row["bound_by"], row["bf16_ops"], row["bytes"] = attention_bound_bf16(
            B, H, T, S, d, peaks)
        rows.append(row)
        emit({"phase": "kernel_check", "kernel": "keybias_attention_bf16", **row})
    return rows


def _rms(a, b=0.0) -> float:
    import numpy as np

    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def phase_generate_bf16(pipe, kb):
    """`generate --bf16`: PipelineConfig() at bfloat16 compute on ``pipe``'s
    weights (the same seed): on the 8 s clip K1's bfloat16 entry runs 12
    times a generate and the float32 one never; outputs finite; exp / jaw /
    style / vertices against ``pipe``'s float32 run on the same weights and
    prior noise (rms, and rms over the float32 output's rms: held below 0.1,
    bfloat16's 8 bits give about 0.01, more is a fault); the six requests
    through generate_batch (36 bfloat16 launches); generate's seconds at
    bfloat16 and float32 in turns."""
    import numpy as np
    import torch

    from avi_talking_tpu_torch.pipeline import AviTalkingPipeline

    bf = AviTalkingPipeline.random_init(pipe.cfg, pipe.head.flame_assets, seed=0,
                                        dtype=torch.bfloat16)
    same = all(torch.equal(a, b) for part in ("clip", "brain", "prior", "head")
               for a, b in zip(bf.state_dict()[part].values(), pipe.state_dict()[part].values()))
    check(same, "the bf16 pipeline's weights differ from the fp32 one's")
    wav = synthetic_wav(8.0, seed=1)
    instruction = "A fairly angry man speaks with brow fairly down"
    rng = np.random.default_rng(3)
    D, steps = pipe.cfg.clip_size, pipe.cfg.timesteps
    noise = {"init": rng.standard_normal((1, 1, D)).astype(np.float32),
             "steps": rng.standard_normal((steps, 1, 1, D)).astype(np.float32)}
    kb.launches = kb.launches_bf16 = 0
    out = bf.generate(wav, instruction, noise=noise)
    launches = {"fp32": kb.launches, "bf16": kb.launches_bf16}
    check(launches == {"fp32": 0, "bf16": 12},
          f"generate --bf16 launched K1 {launches}, not bf16 12 and fp32 0")
    check(out["exp"].shape == (200, pipe.cfg.emote.n_exp)
          and out["vertices"].shape == (200,) + tuple(pipe.head.flame_assets.v_template.shape),
          "generate --bf16 shapes")
    check(all(np.isfinite(v).all() for v in out.values()), "generate --bf16: non-finite output")
    ref = pipe.generate(wav, instruction, noise=noise)
    dist = {}
    for key in ("exp", "jaw", "style_emb", "vertices"):
        d = _rms(out[key], ref[key])
        dist[key] = {"rms": d, "rms_rel": d / _rms(ref[key]),
                     "max_abs": float(np.abs(out[key] - ref[key]).max())}
        check(dist[key]["rms_rel"] < 0.1, f"generate --bf16 {key}: {dist[key]} from fp32")
    wavs = [synthetic_wav(s, seed=10 + i) for i, s in enumerate([3.0, 3.5, 8.0, 9.0, 16.0, 19.0])]
    kb.launches = kb.launches_bf16 = 0
    outs = bf.generate_batch(wavs, ["a happy person speaks", "a sad person", "an angry man shouts",
                                    "calm and neutral", "surprised woman", "a fearful voice"])
    batch_launches = {"fp32": kb.launches, "bf16": kb.launches_bf16}
    check(batch_launches == {"fp32": 0, "bf16": 36},
          f"generate_batch --bf16 launched K1 {batch_launches}")
    check(all(np.isfinite(v).all() for o in outs for v in o.values()), "batch --bf16 non-finite")
    walls = {"fp32": [], "bf16": []}
    for order in (("fp32", "bf16"), ("bf16", "fp32")) * 3:
        for which in order:
            p = pipe if which == "fp32" else bf
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.generate(wav, instruction, seed=0)
            walls[which].append(time.perf_counter() - t0)
    emit({"phase": "generate_bf16", "audio_s": 8.0, "k1_launches": launches,
          "generate_batch_k1_launches": batch_launches, "distance_to_fp32": dist,
          "wall_s_median": {k: statistics.median(v[1:]) for k, v in walls.items()},
          "wall_s_all": walls, "order": "fp32, bf16, bf16, fp32, x3 (the first of each a warm-up)"})
    return launches["bf16"], bf


def phase_serve_bf16(kb):
    """`cli serve --bf16` over the fixture corpus (max_batch 4): every
    request answered, finite, K1 launched in bfloat16 only."""
    import glob

    import numpy as np

    from avi_talking_tpu_torch.cli import main as cli_main

    out_dir = os.path.join(HERE, "build", "chip_smoke", "serve_bf16")
    kb.launches = kb.launches_bf16 = 0
    t0 = time.perf_counter()
    rc = cli_main(["serve", "--json-dir", os.path.join(HERE, "experiments", "json_dir"),
                   "--wav-dir", os.path.join(HERE, "experiments", "wav_dir"), "--bf16",
                   "--max-batch", "4", "--out", out_dir])
    wall = time.perf_counter() - t0
    launches = {"fp32": kb.launches, "bf16": kb.launches_bf16}
    files = sorted(glob.glob(os.path.join(out_dir, "*_coeffs.npz")))
    check(rc == 0 and len(files) >= 4, f"serve --bf16: rc {rc}, {len(files)} outputs")
    check(launches["fp32"] == 0 and launches["bf16"] >= 12 and launches["bf16"] % 12 == 0,
          f"serve --bf16 launched K1 {launches}")
    for f in files:
        z = np.load(f)
        check(all(np.isfinite(z[k]).all() for k in ("exp", "jaw", "style_emb")), f"{f} not finite")
    emit({"phase": "serve_bf16", "requests": len(files), "k1_launches": launches,
          "wall_s": wall})


REFERENCE_EMOTE_NAMES = (  # port prefix -> inferno EMOTE checkpoint prefix
    ("audio_encoder.", "audio_model.model."),
    ("sequence_encoder.", "sequence_encoder.linear."),
    ("style_encoder.map.", "sequence_decoder.obj_vector.map."),
    ("bert_decoder.", "sequence_decoder.bert_decoder."),
    ("decoder.", "sequence_decoder.decoder."),
    ("squasher.", "sequence_decoder.squasher_2.linear."),
    ("motion_prior.", "sequence_decoder.motion_prior.motion_decoder."),
)


def _seeded_state(module, rng):
    """Seeded numpy values for every tensor of ``module``'s state dict, at
    scales that keep the full-width pipeline's activations finite: matrices
    and kernels N(0, 1/fan_in), norm gains 1 + N(0, 0.1^2), other vectors
    N(0, 0.1^2), running variances in [0.5, 1.5)."""
    import numpy as np
    import torch

    out = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64)
            continue
        if k.endswith("running_var"):
            a = 0.5 + rng.random(shape, dtype=np.float32)
        elif len(shape) >= 2:
            a = rng.standard_normal(shape, dtype=np.float32) / np.float32(
                math.sqrt(math.prod(shape[1:])))
        elif k.endswith(".weight") or k.endswith(".g"):  # 1-D: a norm's gain
            a = 1 + 0.1 * rng.standard_normal(shape, dtype=np.float32)
        else:
            a = 0.1 * rng.standard_normal(shape, dtype=np.float32)
        out[k] = torch.from_numpy(a)
    return out


def _flame_2020_pickle(path, lmk_path, mp_path):
    """A FLAME 2020 ``generic_model.pkl``'s arrays at their shapes (5023
    vertices, 9976 faces, 400 shape + expression and 36 pose directions, 5
    joints; J_regressor scipy-sparse, float64 arrays, uint32 faces) and the
    landmark embeddings, from ``synthetic_assets`` at those sizes; returns
    those assets."""
    import pickle

    import numpy as np
    import scipy.sparse

    from avi_talking_tpu_torch.core.assets import synthetic_assets

    a = synthetic_assets(num_vertices=5023, n_shape=300, n_exp=100, num_faces=9976, seed=5,
                         n_static_landmarks=51)
    V = 5023
    m = {"v_template": a.v_template.numpy().astype(np.float64),
         "shapedirs": a.shapedirs.numpy().astype(np.float64),
         "posedirs": a.posedirs.numpy().T.reshape(V, 3, 36).astype(np.float64),
         "J_regressor": scipy.sparse.csc_matrix(a.j_regressor.numpy().astype(np.float64)),
         "weights": a.lbs_weights.numpy().astype(np.float64),
         "f": a.faces.numpy().astype(np.uint32),
         "kintree_table": np.array([[4294967295, 0, 1, 1, 1], [0, 1, 2, 3, 4]], np.int64),
         "bs_style": "lbs", "bs_type": "lrotmin"}
    with open(path, "wb") as f:
        pickle.dump(m, f, protocol=2)
    np.save(lmk_path, {
        "static_lmk_faces_idx": a.lmk_faces_idx.numpy(),
        "static_lmk_bary_coords": a.lmk_bary_coords.numpy(),
        "dynamic_lmk_faces_idx": a.dynamic_lmk_faces_idx.numpy(),
        "dynamic_lmk_bary_coords": a.dynamic_lmk_bary_coords.numpy(),
        "full_lmk_faces_idx": a.full_lmk_faces_idx.numpy()[None],
        "full_lmk_bary_coords": a.full_lmk_bary_coords.numpy()[None]}, allow_pickle=True)
    np.savez(mp_path, lmk_face_idx=a.mediapipe_lmk_faces_idx.numpy(),
             lmk_b_coords=a.mediapipe_lmk_bary_coords.numpy())
    return a


def phase_checkpoint(kb, kras):
    """The user's own weights and FLAME, through the commands a user runs.
    Full-width synthetic reference checkpoints from seeded numpy (an EMOTE
    .ckpt at EmoteConfig() in the inferno layout, the positional conv as
    weight_g / weight_v; the prior trainer's .pth at depth 6 with the
    feed-forward spelled net.{0,1,5}; HF CLIP ViT-L/14 text weights) go
    through `import-emote`, `import-prior` and `import-clip --weights`;
    `generate --checkpoint` (all three) on the card is bit-equal to the same
    pipeline given the same state dicts with load_state_dict (weight norm
    materialised as g * v / ||v||). Then `convert-flame` on a FLAME-2020-
    shaped pickle, `load_flame_assets` on its npz equal to the arrays it was
    made from, and `generate --flame-npz --save-video` on it with K2's 13
    launches."""
    import wave

    import numpy as np
    import torch

    from avi_talking_tpu_torch.cli import main as cli_main
    from avi_talking_tpu_torch.models.brain import BrainNetwork
    from avi_talking_tpu_torch.models.clip_text import ClipTextModel
    from avi_talking_tpu_torch.models.emote import EmoteTalkingHead
    from avi_talking_tpu_torch.models.prior_transformer import PriorTransformerNetwork
    from avi_talking_tpu_torch.pipeline import AviTalkingPipeline, PipelineConfig

    root = os.path.join(HERE, "build", "chip_smoke", "checkpoint")
    os.makedirs(root, exist_ok=True)
    os.environ["AVI_TALKING_CLIP_TOKENIZER"] = os.path.join(
        HERE, "avi_talking_tpu_torch", "text", "default_vocab")
    cfg = PipelineConfig()
    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    with torch.device("meta"):
        mods = {"clip": ClipTextModel(cfg.clip),
                "brain": BrainNetwork(out_dim=cfg.clip_size, in_dim=cfg.clip.hidden_size,
                                      clip_size=cfg.clip_size),
                "prior": PriorTransformerNetwork(dim=cfg.clip_size, depth=cfg.prior_depth,
                                                 heads=cfg.prior_heads,
                                                 dim_head=cfg.prior_dim_head),
                "head": EmoteTalkingHead(cfg.emote)}
    states = {part: _seeded_state(m, rng) for part, m in mods.items()}
    # the EMOTE .ckpt, the positional conv as a weight norm (w = g v / ||v||)
    pc = "audio_encoder.encoder.pos_conv_embed.conv."
    v_np = states["head"].pop(pc + "weight").numpy()
    g_np = (0.5 + rng.random((1, 1, v_np.shape[2]), dtype=np.float32))
    states["head"][pc + "weight"] = torch.from_numpy(np.ascontiguousarray(
        g_np * v_np / np.sqrt((v_np ** 2).sum(axis=(0, 1), keepdims=True))))
    emote_sd = {}
    for k, t in states["head"].items():
        if k == pc + "weight":
            continue
        src, dst = next((s, d) for s, d in REFERENCE_EMOTE_NAMES if k.startswith(s))
        emote_sd["talking_head_model." + dst + k[len(src):]] = t
    wn = "talking_head_model.audio_model.model.encoder.pos_conv_embed.conv."
    emote_sd[wn + "weight_g"] = torch.from_numpy(g_np)
    emote_sd[wn + "weight_v"] = torch.from_numpy(v_np)
    torch.save({"state_dict": emote_sd}, os.path.join(root, "emote.ckpt"))
    prior_sd = {"voxel2clip." + k: t for k, t in states["brain"].items()}
    for k, t in states["prior"].items():
        p = k.split(".")
        if k.startswith("causal_transformer.layers.") and p[3] == "1":
            k = ".".join(p[:4] + ["net"] + p[4:])
        prior_sd["net." + k] = t
    torch.save({"epoch": 1, "model_state_dict": prior_sd}, os.path.join(root, "last.pth"))
    clip_sd = {"text_model." + k: t for k, t in states["clip"].items()}
    clip_sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    torch.save(clip_sd, os.path.join(root, "clip.bin"))
    write_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    cks = {name: os.path.join(root, f"ck_{name}") for name in ("emote", "prior", "clip")}
    check(cli_main(["import-emote", "--ckpt", os.path.join(root, "emote.ckpt"),
                    "--out", cks["emote"]]) == 0, "import-emote failed")
    check(cli_main(["import-prior", "--pth", os.path.join(root, "last.pth"),
                    "--out", cks["prior"]]) == 0, "import-prior failed")
    check(cli_main(["import-clip", "--src", os.environ["AVI_TALKING_CLIP_TOKENIZER"],
                    "--dest", os.path.join(root, "clip_tokenizer"),
                    "--weights", os.path.join(root, "clip.bin"), "--out", cks["clip"]]) == 0,
          "import-clip failed")
    import_s = time.perf_counter() - t0

    wav = os.path.join(root, "clip.wav")
    pcm = (np.clip(synthetic_wav(8.0, seed=1), -1, 1) * 32767).astype("<i2")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    text = "a fairly angry man speaks with brow fairly down"
    ck_args = [a for name in ("clip", "prior", "emote") for a in ("--checkpoint", cks[name])]
    # bit-equality across pipelines: cuDNN's default algorithms may reorder sums
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        kb.launches = 0
        t0 = time.perf_counter()
        check(cli_main(["generate", "--wav", wav, "--text", text, "--seed", "0",
                        "--out", os.path.join(root, "out"), *ck_args]) == 0, "generate failed")
        cli_s = time.perf_counter() - t0
        check(kb.launches == 12, f"generate --checkpoint launched K1 {kb.launches} times")
        got = np.load(os.path.join(root, "out", "clip_coeffs.npz"))
        direct = AviTalkingPipeline.random_init(cfg, None, seed=1)
        direct.load_state_dict(states)
        ref = direct.generate(wav, text, seed=0)
        diffs = {k: float(np.abs(got[k] - ref[k]).max()) for k in ("exp", "jaw", "style_emb")}
        check(all(np.array_equal(got[k], ref[k]) for k in diffs),
              f"generate --checkpoint vs load_state_dict: max |d| {diffs}")
        k2, video, video_s, expect = _checkpoint_flame(root, wav, text, ck_args, got, kb, kras)
    finally:
        torch.backends.cudnn.deterministic = det
    emit({"phase": "checkpoint", "params": {p: sum(t.numel() for t in s.values())
                                            for p, s in states.items()},
          "write_s": write_s, "import_s": import_s, "generate_checkpoint_s": cli_s,
          "bit_equal_to_load_state_dict": True, "k1_launches": 12,
          "flame_npz_fields_equal": sorted(expect), "k2_launches_save_video": k2,
          "video_outputs": len(video), "generate_flame_video_s": video_s,
          "cudnn_deterministic": True})
    return k2


def _checkpoint_flame(root, wav, text, ck_args, got, kb, kras):
    """phase_checkpoint's FLAME half: convert-flame, load_flame_assets
    against the arrays the pickle was made from, then generate --flame-npz
    --save-video with K1's and K2's launches; the coefficients equal the
    run without FLAME (``got``)."""
    import glob

    import numpy as np
    import torch

    from avi_talking_tpu_torch.cli import main as cli_main
    from avi_talking_tpu_torch.core.assets import load_flame_assets

    pkl = os.path.join(root, "generic_model.pkl")
    lmk, mp = os.path.join(root, "landmark_embedding.npy"), os.path.join(root, "mediapipe.npz")
    made = _flame_2020_pickle(pkl, lmk, mp)
    npz = os.path.join(root, "flame.npz")
    check(cli_main(["convert-flame", "--pkl", pkl, "--out", npz, "--lmk-embedding", lmk,
                    "--mediapipe-lmk-embedding", mp]) == 0, "convert-flame failed")
    loaded = load_flame_assets(npz, 300, 50)
    expect = {"v_template": made.v_template, "posedirs": made.posedirs,
              "j_regressor": made.j_regressor, "lbs_weights": made.lbs_weights,
              "faces": made.faces,
              "shapedirs": torch.cat([made.shapedirs[..., :300], made.shapedirs[..., 300:350]], -1),
              "lmk_faces_idx": made.lmk_faces_idx, "dynamic_lmk_bary_coords":
                  made.dynamic_lmk_bary_coords, "mediapipe_lmk_faces_idx":
                  made.mediapipe_lmk_faces_idx}
    for k, t in expect.items():
        check(torch.equal(getattr(loaded, k), t), f"convert-flame -> load_flame_assets: {k}")
    kras.launches = kb.launches = 0
    t0 = time.perf_counter()
    check(cli_main(["generate", "--wav", wav, "--text", text, "--seed", "0", "--flame-npz", npz,
                    "--save-video", "--out", os.path.join(root, "out_flame"), *ck_args]) == 0,
          "generate --flame-npz --save-video failed")
    video_s = time.perf_counter() - t0
    k2 = kras.launches
    check(k2 == 13 and kb.launches == 12,
          f"--flame-npz --save-video launched K2 {k2} (not 13), K1 {kb.launches}")
    video = glob.glob(os.path.join(root, "out_flame", "clip.mp4")) + glob.glob(
        os.path.join(root, "out_flame", "clip_frames", "*.png"))
    check(len(video) >= 1, "no video written")
    again = np.load(os.path.join(root, "out_flame", "clip_coeffs.npz"))
    check(all(np.array_equal(again[k], got[k]) for k in ("exp", "jaw")),
          "FLAME changed the coefficients")
    return k2, video, video_s, expect


def profile_call(fn) -> dict:
    """One call of ``fn`` under torch.profiler: wall time, device time by
    kernel and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for evt in prof.key_averages():
        # device-side rows only (kernels, copies); CPU op rows repeat their time
        # and a user annotation's device span (the optimizer's step) covers
        # kernels that have rows of their own
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            kernels.append((evt.self_device_time_total, evt.key, evt.count))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
            "device_launches": sum(k[2] for k in kernels),
            "top": [{"kernel": k[:90], "ms": t / 1e3, "count": n} for t, k, n in kernels[:15]]}


def phase_profile(pipe, verts, faces):
    """The style stage's wall time alone (CLIP, brain, 100-step prior), then
    one generate call and one 200-frame render_verts under torch.profiler."""
    import torch

    from avi_talking_tpu_torch.viz import FlameVisualizer

    wav = synthetic_wav(8.0, seed=1)
    instruction = "A fairly angry man speaks with brow fairly down"
    pipe.generate(wav, "warm up", seed=0)
    style_walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        pipe.sample_style(instruction, seed=0)
        torch.cuda.synchronize()
        style_walls.append(time.perf_counter() - t0)
    emit({"phase": "profile", "call": "generate",
          "style_wall_ms_median": statistics.median(style_walls) * 1e3,
          **profile_call(lambda: pipe.generate(wav, instruction, seed=0))})
    viz = FlameVisualizer(faces, 256)
    viz.render_verts(verts)
    emit({"phase": "profile", "call": "render_verts", "frames": len(verts),
          **profile_call(lambda: viz.render_verts(verts))})
    profile_train_step()
    profile_emote_and_prior_steps()


def profile_emote_and_prior_steps():
    """One EMOTE training step at train-emote's defaults (B=8, 64 frames)
    and one prior step at PriorTrainingConfig() (B=256), full width, under
    torch.profiler after two warm-up steps each."""
    import numpy as np
    import torch

    from avi_talking_tpu_torch.cli.train_emote import build_head, synthetic_batches
    from avi_talking_tpu_torch.train.driver import (
        PriorTrainingConfig, build_state, step_generator, synthetic_batches as prior_batches)
    from avi_talking_tpu_torch.train.prior import PriorTrainer

    head = build_head(tiny=False, seed=0, device=torch.device("cuda"))
    trainer = _emote_trainer(head, 1e-4)
    batches = synthetic_batches(np.random.default_rng(0), 8, 64, head.cfg.flint.n_exp,
                                head.cfg.n_shape, "cuda")
    for _ in range(2):
        trainer.train_step(next(batches))
    batch = next(batches)
    emit({"phase": "profile", "call": "train_emote_step", "batch": 8, "frames": 64,
          **profile_call(lambda: trainer.train_step(batch))})
    del trainer, head

    cfg = PriorTrainingConfig()
    state = build_state(cfg, seed=0, device=torch.device("cuda"))
    ptrainer = PriorTrainer()
    b = next(prior_batches(cfg.batch_size, 1, cfg.in_dim, cfg.clip_size))
    voxel, style = (torch.from_numpy(b[k]).cuda() for k in ("voxel", "style_target"))
    for i in range(2):
        ptrainer.train_step(state, voxel, style, 0.006, generator=step_generator("cuda", 0, i))
    emit({"phase": "profile", "call": "train_prior_step", "batch": cfg.batch_size,
          **profile_call(lambda: ptrainer.train_step(state, voxel, style, 0.006,
                                                     generator=step_generator("cuda", 0, 2)))})


def profile_train_step():
    """One FaceFormer training step at the CLI's defaults (B=16, T=25,
    full width) under torch.profiler, after two warm-up steps."""
    from avi_talking_tpu_torch.cli.train import synthetic_batches
    from avi_talking_tpu_torch.models.faceformer import FaceFormerConfig
    from avi_talking_tpu_torch.train.faceformer_trainer import FaceFormerTrainer
    from avi_talking_tpu_torch.train.optim import adamw

    cfg = FaceFormerConfig()
    model = _faceformer_model(cfg, seed=0, device="cuda")
    trainer = FaceFormerTrainer(model=model, optimizer=adamw(model.parameters(), 1e-4))
    batches = synthetic_batches(cfg, 16, 25, seed=0, device="cuda")
    for _ in range(2):
        trainer.train_step(next(batches))
    batch = next(batches)
    emit({"phase": "profile", "call": "train_faceformer_step", "batch": 16, "seq_length": 25,
          **profile_call(lambda: trainer.train_step(batch))})


def check_emote_row(rows, emote) -> dict:
    """K1's row at the EMOTE step's shape, checked against the shape the
    train_emote phase saw."""
    row = next(r for r in rows if r["case"] == "emote_train")
    check(row["shape"] == emote["k1_shape"],
          f"K1 measured at {row['shape']}, the EMOTE step runs {emote['k1_shape']}")
    return row


def check_vert_row(rows, vert) -> dict:
    """K1's row at train-faceformer-vert's step, checked against the shape
    the step's encoder saw."""
    row = next(r for r in rows if r["case"] == "vert_train")
    check(row["shape"] == vert["k1_shape"],
          f"K1 measured at {row['shape']}, the vertex step runs {vert['k1_shape']}")
    return row


def check_faceformer_row(rows, data) -> dict:
    """K1's row at train-faceformer's step, checked against the shape the
    --root step's encoder saw."""
    row = next(r for r in rows if r["case"] == "faceformer_train")
    check(row["shape"] == data["ff_k1_shape"],
          f"K1 measured at {row['shape']}, the train-faceformer step runs {data['ff_k1_shape']}")
    return row


def finish(name: str, **extra) -> int:
    """The card's name and power limit, then the result line."""
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, **extra, "device": {"platform": "gpu", "kind": name,
                                          "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Chip check of the PyTorch / CUDA port.")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one generate, one render and each training step")
    ap.add_argument("--phases", choices=("all", "train"), default="all",
                    help="train: only the build, K1's rows, the K1 / K3 gradient rows and the "
                         "EMOTE (geometric and neural), vertex FaceFormer, prior and "
                         "data-backed training phases")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "avi_talking_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()

    from avi_talking_tpu_torch.core.assets import synthetic_assets
    from avi_talking_tpu_torch.ops.kernels import bias_attention as kba
    from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb
    from avi_talking_tpu_torch.ops.kernels import rasterize as kras
    from avi_talking_tpu_torch.pipeline import AviTalkingPipeline, PipelineConfig

    name = torch.cuda.get_device_name(0)
    variant, peaks = card_peaks(name)
    ptxas = phase_build()
    rows = phase_kernels(peaks)
    if args.phases == "train":
        phase_attention_grads(peaks)
        emote = phase_train_emote(kb)
        check_emote_row(rows, emote)
        phase_train_emote_neural(kb, kras, peaks, profile=args.profile)
        vert = phase_train_faceformer_vert(kb, kba, kras, peaks, profile=args.profile)
        check_vert_row(rows, vert)
        phase_train_prior()
        check_faceformer_row(rows, phase_train_data(kb, kba))
        if args.profile:
            profile_emote_and_prior_steps()
        emit({"phases": "train", "total_s": time.perf_counter() - t_start})
        return finish(name, phases="train")
    k3_rows = phase_bias_kernels(peaks)
    grad_rows = phase_attention_grads(peaks)

    t0 = time.perf_counter()
    assets = synthetic_assets(num_vertices=5023, n_shape=300, n_exp=50, num_faces=9976)
    pipe = AviTalkingPipeline.random_init(PipelineConfig(), assets, seed=0)
    emit({"phase": "init", "device": str(pipe.device), "seconds": time.perf_counter() - t0})
    gen_launches, gen_out = phase_generate(pipe, kb)
    phase_generate_batch(pipe, kb)
    phase_gpu_vs_cpu(pipe)
    faces = assets.faces.cuda()
    vis_rows = phase_visibility(gen_out["vertices"], faces, peaks,
                                ptxas.get("rasterize_visibility", []))
    render_launches = phase_render(gen_out["vertices"], faces)
    phase_render_gpu_vs_cpu()
    phase_serve(pipe, kb)
    bf16_rows = phase_kernels_bf16(peaks)
    bf16_launches, _ = phase_generate_bf16(pipe, kb)
    phase_serve_bf16(kb)
    ckpt_k2 = phase_checkpoint(kb, kras)
    ff_launches = phase_faceformer(kb, kba)
    phase_train_faceformer(kb, kba)
    emote = phase_train_emote(kb)
    neural = phase_train_emote_neural(kb, kras, peaks, profile=args.profile)
    vert = phase_train_faceformer_vert(kb, kba, kras, peaks, profile=args.profile)
    phase_train_prior()
    data = phase_train_data(kb, kba)
    if args.profile:
        phase_profile(pipe, gen_out["vertices"], faces)

    peaks_line = {"variant": variant, "fp32_flops": peaks[0], "bytes_per_s": peaks[1],
                  "tf32_flops": peaks[2], "bf16_flops": peaks[3]}
    bf16_main = bf16_rows[0]  # generate --bf16's shape: B=1, H=12, T=S=200, d=64
    main_row = rows[0]  # the generate path's shape: B=1, H=12, T=S=200, d=64
    vis_row = vis_rows[0]  # the render path's launch: 16 frames x 64 tiles
    k3_main = k3_rows[1]  # the forward's self-attention: B=1 H=4 T=S=600 d=32, (H, T, T) bias
    emote_row = check_emote_row(rows, emote)
    neural_row = neural["row"]  # K2 at the predicted video's launch: 2B x T = 128 frames x 16 tiles
    vert_k1 = check_vert_row(rows, vert)  # K1 at train-faceformer-vert's step: B=4 T=S=100
    vert_k3 = vert["k3_rows"][0]  # K3's self-attention at the vertex decoder: B=4 H=4 T=S=100 d=16
    vert_k2 = vert["k2_row"]  # K2 at the emotion loss's launch: 20 frames x 16 tiles
    ff_k1 = check_faceformer_row(rows, data)  # K1 at train-faceformer's step: B=16 T=S=25
    ff_k3 = k3_rows[0]  # K3's self-attention at train-faceformer's step: B=16 H=4 T=S=25 d=32
    emit({"kernels": [{
        "name": "keybias_attention",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/bias_attention.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:114",
        "launches": gen_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "device_ms": main_row["device_ms"],
        "library_device_ms": main_row["library_device_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
        "peaks": peaks_line,
    }, {
        "name": "keybias_attention_bf16",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/keybias_attention_bf16.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:114",
        "path": "generate --bf16 (bfloat16 q, k, v in every wav2vec2 layer)",
        "launches": bf16_launches,
        "max_abs_err": max(r["max_abs_err"] for r in bf16_rows),
        "limit_share": max(max(r["limit_share"], r["rms_limit_share"]) for r in bf16_rows),
        "ms": bf16_main["ms"],
        "device_ms": bf16_main["device_ms"],
        "library_device_ms": bf16_main["library_device_ms"],
        "plain_ms": bf16_main["plain_ms"],
        "bound_ms": bf16_main["bound_ms"],
        "bound_by": bf16_main["bound_by"],
        "library_ms": bf16_main["library_ms"],
        "shape": bf16_main["shape"],
        "dtype": "bfloat16",
        "peaks": peaks_line,
    }, {
        "name": "rasterize_tiles_visibility",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/rasterize_visibility.cu",
        "replaces": "avi_talking_tpu/ops/pallas/rasterize.py:111",
        "path": "generate --checkpoint --flame-npz --save-video (convert-flame's npz)",
        "launches": ckpt_k2,
        "max_abs_err": max(r["max_abs_err"] for r in vis_rows),
        "ms": vis_row["ms"],
        "device_ms": vis_row["device_ms"],
        "plain_ms": vis_row["plain_ms"],
        "bound_ms": vis_row["bound_ms"],
        "bound_by": vis_row["bound_by"],
        "bound_ms_no_fma": vis_row["bound_ms_no_fma"],
        "library_ms": None,  # no PyTorch call computes z-buffer visibility
        "shape": vis_row["shape"],
        "peaks": peaks_line,
    }, {
        "name": "rasterize_tiles_visibility",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/rasterize_visibility.cu",
        "replaces": "avi_talking_tpu/ops/pallas/rasterize.py:111",
        "launches": render_launches,
        "max_abs_err": max(r["max_abs_err"] for r in vis_rows),
        "ms": vis_row["ms"],
        "device_ms": vis_row["device_ms"],
        "plain_ms": vis_row["plain_ms"],
        "bound_ms": vis_row["bound_ms"],
        "bound_by": vis_row["bound_by"],
        "bound_ms_no_fma": vis_row["bound_ms_no_fma"],
        "library_ms": None,  # no PyTorch call computes z-buffer visibility
        "shape": vis_row["shape"],
        "peaks": peaks_line,
    }, {
        "name": "fused_bias_attention",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/bias_attention.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:185",
        "launches": ff_launches["fused_bias_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in k3_rows),
        "ms": k3_main["ms"],
        "device_ms": k3_main["device_ms"],
        "library_device_ms": k3_main["library_device_ms"],
        "plain_ms": k3_main["plain_ms"],
        "bound_ms": k3_main["bound_ms"],
        "bound_by": k3_main["bound_by"],
        "library_ms": k3_main["library_ms"],
        "shape": k3_main["shape"],
        "bias_shape": k3_main["bias_shape"],
        "backward": {k: v for k, v in grad_rows[1].items() if k != "kernel"},
        "peaks": peaks_line,
    }, {
        "name": "keybias_attention",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/bias_attention.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:114",
        "launches": emote["launches"],  # the train-emote command's run
        "max_abs_err": emote_row["max_abs_err"],
        "ms": emote_row["ms"],
        "device_ms": emote_row["device_ms"],
        "library_device_ms": emote_row["library_device_ms"],
        "plain_ms": emote_row["plain_ms"],
        "bound_ms": emote_row["bound_ms"],
        "bound_by": emote_row["bound_by"],
        "library_ms": emote_row["library_ms"],
        "shape": emote_row["shape"],
        "backward": {k: v for k, v in grad_rows[2].items() if k != "kernel"},
        "peaks": peaks_line,
    }, {
        "name": "rasterize_tiles_visibility",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/rasterize_visibility.cu",
        "replaces": "avi_talking_tpu/ops/pallas/rasterize.py:111",
        "path": "train-emote --neural (the predicted video's render, under a gradient)",
        "launches": neural["launches"]["rasterize_tiles_visibility"],  # the command's run
        "max_abs_err": neural_row["max_abs_err"],
        "ms": neural_row["ms"],
        "device_ms": neural_row["device_ms"],
        "plain_ms": neural_row["plain_ms"],
        "bound_ms": neural_row["bound_ms"],
        "bound_by": neural_row["bound_by"],
        "bound_ms_no_fma": neural_row["bound_ms_no_fma"],
        "library_ms": None,  # no PyTorch call computes z-buffer visibility
        "shape": neural_row["shape"],
        "peaks": peaks_line,
    }, {
        "name": "keybias_attention",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/bias_attention.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:114",
        "path": "train-faceformer-vert --mead-root --disentangle --emo-cls",
        "launches": vert["launches"]["keybias_attention"],  # the command's run
        "max_abs_err": vert_k1["max_abs_err"],
        "ms": vert_k1["ms"],
        "device_ms": vert_k1["device_ms"],
        "library_device_ms": vert_k1["library_device_ms"],
        "plain_ms": vert_k1["plain_ms"],
        "bound_ms": vert_k1["bound_ms"],
        "bound_by": vert_k1["bound_by"],
        "library_ms": vert_k1["library_ms"],
        "shape": vert_k1["shape"],
        "peaks": peaks_line,
    }, {
        "name": "fused_bias_attention",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/bias_attention.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:185",
        "path": "train-faceformer-vert --mead-root --disentangle --emo-cls",
        "launches": vert["launches"]["fused_bias_attention"],  # the command's run
        "max_abs_err": max(r["max_abs_err"] for r in vert["k3_rows"]),
        "ms": vert_k3["ms"],
        "device_ms": vert_k3["device_ms"],
        "library_device_ms": vert_k3["library_device_ms"],
        "plain_ms": vert_k3["plain_ms"],
        "bound_ms": vert_k3["bound_ms"],
        "bound_by": vert_k3["bound_by"],
        "library_ms": vert_k3["library_ms"],
        "shape": vert_k3["shape"],
        "bias_shape": vert_k3["bias_shape"],
        "backward": {k: v for k, v in vert["k3_grads"][0].items() if k != "kernel"},
        "peaks": peaks_line,
    }, {
        "name": "rasterize_tiles_visibility",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/rasterize_visibility.cu",
        "replaces": "avi_talking_tpu/ops/pallas/rasterize.py:111",
        "path": "train-faceformer-vert --mead-root --disentangle --emo-cls (the emotion loss's "
                "render, under a gradient)",
        "launches": vert["launches"]["rasterize_tiles_visibility"],  # the command's run
        "max_abs_err": vert_k2["max_abs_err"],
        "ms": vert_k2["ms"],
        "device_ms": vert_k2["device_ms"],
        "plain_ms": vert_k2["plain_ms"],
        "bound_ms": vert_k2["bound_ms"],
        "bound_by": vert_k2["bound_by"],
        "bound_ms_no_fma": vert_k2["bound_ms_no_fma"],
        "library_ms": None,  # no PyTorch call computes z-buffer visibility
        "shape": vert_k2["shape"],
        "peaks": peaks_line,
    }, {
        "name": "keybias_attention",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/bias_attention.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:114",
        "path": "train-emote --root (MEAD windows read from disk)",
        "launches": data["emote_launches"],  # the command's run
        "max_abs_err": emote_row["max_abs_err"],
        "ms": emote_row["ms"],
        "device_ms": emote_row["device_ms"],
        "library_device_ms": emote_row["library_device_ms"],
        "plain_ms": emote_row["plain_ms"],
        "bound_ms": emote_row["bound_ms"],
        "bound_by": emote_row["bound_by"],
        "library_ms": emote_row["library_ms"],
        "shape": emote_row["shape"],
        "peaks": peaks_line,
    }, {
        "name": "keybias_attention",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/bias_attention.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:114",
        "path": "train-faceformer --root (MEAD windows and crops read from disk, FAN "
                "conditioning)",
        "launches": data["ff_launches"]["keybias_attention"],  # the command's run
        "max_abs_err": ff_k1["max_abs_err"],
        "ms": ff_k1["ms"],
        "device_ms": ff_k1["device_ms"],
        "library_device_ms": ff_k1["library_device_ms"],
        "plain_ms": ff_k1["plain_ms"],
        "bound_ms": ff_k1["bound_ms"],
        "bound_by": ff_k1["bound_by"],
        "library_ms": ff_k1["library_ms"],
        "shape": ff_k1["shape"],
        "peaks": peaks_line,
    }, {
        "name": "fused_bias_attention",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/bias_attention.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:185",
        "path": "train-faceformer --root (MEAD windows and crops read from disk, FAN "
                "conditioning)",
        "launches": data["ff_launches"]["fused_bias_attention"],  # the command's run
        "max_abs_err": ff_k3["max_abs_err"],
        "ms": ff_k3["ms"],
        "device_ms": ff_k3["device_ms"],
        "library_device_ms": ff_k3["library_device_ms"],
        "plain_ms": ff_k3["plain_ms"],
        "bound_ms": ff_k3["bound_ms"],
        "bound_by": ff_k3["bound_by"],
        "library_ms": ff_k3["library_ms"],
        "shape": ff_k3["shape"],
        "bias_shape": ff_k3["bias_shape"],
        "peaks": peaks_line,
    }], "keybias_attention_backward": {k: v for k, v in grad_rows[0].items() if k != "kernel"},
        "total_s": time.perf_counter() - t_start})
    return finish(name)


if __name__ == "__main__":
    sys.exit(main())
