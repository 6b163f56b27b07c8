#!/usr/bin/env python3
"""Chip check of the PyTorch / CUDA port (avi_talking_tpu_torch) on one card.

    python3 chip_smoke.py              # the check; needs one CUDA card and nvcc
    python3 chip_smoke.py --profile    # also profiles one generate, one render
                                       # and one FaceFormer, EMOTE, vertex
                                       # FaceFormer and prior training step
                                       # each
    python3 chip_smoke.py --phases train [--profile]
                                       # the build, the host codecs, K1's rows,
                                       # the gradient rows and the training
                                       # phases alone; its result line says
                                       # "phases": "train"
    python3 chip_smoke.py --phases pirender
                                       # the build, the host codecs, K1's rows
                                       # and the portrait, render-loss and
                                       # train-pirender phases alone
    python3 chip_smoke.py --phases emoca
                                       # the build, the host codecs, K1's rows
                                       # and the train-emoca and reconstruct
                                       # phases alone
    python3 chip_smoke.py --phases preprocess
                                       # the build, the host codecs, K1's rows
                                       # and the preprocess, bfm and
                                       # support_nets phases alone
    python3 chip_smoke.py --phases flint
                                       # the build, the host codecs, K1's rows
                                       # and the train_flint, specaugment,
                                       # ablation and infra phases alone
    python3 chip_smoke.py --phases parallel
                                       # the build, the host codecs, K1's rows
                                       # and the parallel phase alone
    python3 chip_smoke.py --phases faceformer_bf16
                                       # the build, the host codecs, K1's rows
                                       # and the faceformer_bf16 phase alone

Run it from the root of a checkout: it builds the port's CUDA kernels from
the checkout's sources into build/, then

1. build:   every kernel of the port (one nvcc per source, all started
            together), reported in seconds with the compiler's register and
            spill report; a spill fails the check;
2. host codecs: native/wavio.cpp and native/imageio.cpp built by g++
            at first use into build/, their decodes held to the Python
            versions (a 16 kHz and a resampled 48 kHz wav, the framing, the
            PNG golden file with all five row filters and a 224^2 crop under
            each), with the decode's milliseconds native and Python;
3. kernels: K1 (key-bias attention) against its plain PyTorch version on the
            card at the generate path's shapes, the FaceFormer encoder's and
            the EMOTE, vertex FaceFormer and FaceFormer training steps' and
            Wav2Vec2SER's forward on 8 s, and K3 (biased attention) at the FaceFormer decoder's four
            shapes, each with its time (CUDA events around the wrapper, and
            the kernel's own device time under torch.profiler), the plain
            version's, one PyTorch library call's and the card's lower
            bound; K1's and K3's gradients on the card against the same
            formula on CPU copies, and the backward's time at the training
            shapes;
4. generate: full-width PipelineConfig() with seeded random weights and
            full-size synthetic FLAME assets on an 8 s clip: shapes,
            finiteness, same seed -> same output, kernel launches, time;
5. generate_batch: six requests over three length buckets;
6. GPU vs CPU: the same weights and explicit noise through the port on the
            card and on the CPU, as an explicit reference;
7. diversity: the style diversity score on the card against the CPU
            with the same prior draws, and the `diversity` command at full
            width (4 samples);
8. visibility: K2 (rasterizer visibility) held bit-equal to its plain
            version at three shapes (the render path's launch, a closed
            FLAME-density head mesh at 256^2 / tile 32 and at 224^2 /
            tile 56), with its times (CUDA events and device time), both
            bounds (at the FMA peak, and at the fp32 issue rate its
            rounded arithmetic is held to), the live slots per tile and
            the launch's blocks;
9. render:  the 200 frames of the 8 s clip through FlameVisualizer into a
            video under build/chip_smoke/: K2 launches, repeatability, wall
            time; the kernel route against the dense plain rasterizer on the
            head mesh;
10. render GPU vs CPU: four head-mesh frames through the visualizer on the
            card and on the CPU;
11. serve:   the fixture caption corpus (experiments/) through InferenceServer
            at max_batch 4, driven as `cli serve` drives it, each result held
            to generate_batch on the same padded micro-batch; p50 / p99;
12. kernel_check bf16: K1's bfloat16 entry against its plain version at
            the generate shapes (B=1 H=12 T=S=200, 333, 600; B=2 T=S=512)
            and at one shape past its shared-memory fit (streamed, marked),
            and at `train-emote --bf16`'s step (B=8 T=S=64), with its times,
            SDPA's at bfloat16 and the bf16-peak bound; K1's bfloat16
            gradient at that step, card vs CPU, and its backward's time
            beside SDPA's;
13. generate_bf16: `--bf16` at full width on the fp32 pipeline's weights:
            K1 bf16 12 launches a generate and fp32 0, finite outputs, the
            distance to the fp32 run on the same weights and noise, the six
            requests, generate's seconds at bf16 and fp32 in turns; then
            `cli serve --bf16` over the fixture corpus;
14. checkpoint: full-width synthetic reference checkpoints (EMOTE, the
            prior's .pth, HF CLIP text) through `import-emote`,
            `import-prior`, `import-clip --weights`; `generate --checkpoint`
            bit-equal to load_state_dict; `convert-flame` on a
            FLAME-2020-shaped pickle, then `--flame-npz --save-video` on it
            with K2's launches;
15. faceformer: full-width FaceFormerConfig() (wav2vec2-base, decoder 128
            wide) on 24 s of audio: the teacher-forced forward and the
            KV-cached predict, with K1 / K3 launches, AR vs teacher-forced
            consistency, the card against the CPU, repeatability and times;
15b. faceformer_bf16: the FaceFormer family at bfloat16 compute: K3's
            bfloat16 entry against its plain version at the decoders'
            shapes (with SDPA's time at bfloat16 and the bf16 bound); the
            four attention entries at head dims 1 to 128, B*H = 65,544 and
            a bias of the other dtype; FaceFormerConfig() on 24 s and
            FaceFormerVertConfig() at B=4, T=100 at bfloat16 (K1 bf16 12 and
            K3 bf16 2 a forward, K1 bf16 12 a predict, fp32 entries 0;
            within 0.1 rms of fp32, card vs CPU by the CPU tests' rule, AR
            vs teacher-forced, bf16 / fp32 seconds in turns);
            `train-emote --tiny --bf16` (heads 8 wide) on the card;
16. train_faceformer: `cli train-faceformer` at its defaults (B=16, T=25)
            for 5 steps, launches per step, step time; one step on the card
            against the same step on the CPU;
17. train_emote: the EMOTE head at full width and `train-emote`'s defaults
            (B=8, 64 frames): the shape K1 sees, K1 launches per step, step
            time; one step card vs CPU; the `train-emote` command for two
            stages of 3 steps with a run directory, and `last` restored;
18. train_emote_bf16: `train-emote --bf16` at full width (B=8, 64
            frames): the command for two stages of 3 steps (K1 bf16 12 a
            forward, fp32 0); a bf16 step against an fp32 step on the card
            from the same weights (each gradient within 0.1 of fp32's rms),
            the two in turns with peak memory; the card at bf16 against the
            CPU at bf16 at the tiny width (heads 16 wide);
19. train_emote_neural: EMOTE's neural-loss stage at full width (renders
            at 224^2, the three towers at seeded random init): `train-emote
            --neural` at B=2, 32 frames; one neural step card vs CPU and
            the render and towers on identical vertices; the step's time,
            frames per second, K2 launches and device ms, peak memory; K2
            at the predicted video's launch (2048 tiles) against its plain
            version;
20. train_emote_neural_bf16: `train-emote --neural --bf16` at B=2, 32
            frames (K1 bf16 96 and K2 8 launches, fp32 K1 0); bf16 against
            fp32 on the card: the loss, and the vertex gradient through the
            float32 render and the bfloat16 towers on identical vertices,
            each within 0.1; the steps in turns with peak memory; one bf16
            step at the command's defaults (B=8, 64 frames), its peak memory
            recorded, not held;
21. train_faceformer_vert: `train-faceformer-vert` at full width
            (FaceFormerVertConfig(), B=4, 100 frames) on a synthetic MEAD
            tree and a synthetic full-size FLAME: synthetic and
            --disentangle runs with checkpoints loaded back; the main path
            `--mead-root --disentangle --emo-cls` with K1, K3 and K2 under
            every step; the emotion head's pretrain round trip; one step
            card vs CPU (B=2, 40 frames) and one `train-faceformer` step
            with the landmark terms; the step's time, launches and peak
            memory; K3 at the decoder's shape forward and backward, K2 at
            the emotion loss's launch;
22. train_prior: the prior trainer at full width (B=256): step time; one
            step card vs CPU with the same draws; `train-prior` for 4 steps
            with validation and checkpoints, then --resume from step 4;
23. train_data: the data-backed commands on a synthetic MEAD tree of 18
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
24. portrait: `generate` on the 8 s clip, then `portrait --coeffs` at
            PIRenderConfig() and 256^2 (--chunk 32, 200 frames): shapes,
            repeatability, frames/s, peak memory; card vs CPU, chunked vs
            per-frame, --bf16 vs fp32, --net-g bit-equal to load_state_dict,
            --control;
25. train_faceformer_render: `train-faceformer --root --render-loss
            --emo-loss` at its defaults (B=16, T=25, 224^2 crops): K1 12 / 12
            and K3 2 / 2 forwards / backwards a step, both terms nonzero with a
            gradient to the model, step seconds, peak memory; one step card vs
            CPU at B=2;
26. train_pirender: `train-pirender` at PIRenderConfig() (256^2, B=4):
            warp, full and --gan steps, synthetic and --root --cross-id; one
            step of each stage card vs CPU at B=1; the editing net's first
            full-stage update against optax's shared step count;
27. train_emoca: `train-emoca` at full width and its defaults (224^2,
            B=8) on a folder of 24 PNG frames with landmarks: the coarse
            stage, --exp-only (E_flame bit-unchanged), --emo-loss and
            --detail from the coarse checkpoint (only E_detail and the
            generator move, its running statistics too), K2 once a step;
            one coarse and one detail step card vs CPU at B=2; K2 at the
            render's launch (8 frames x 16 tiles) against its plain version;
28. reconstruct: `reconstruct --detail --textured` on 16 frames at 256^2:
            the files, K2's 2 launches, frames/s; 2 frames card vs CPU
            (codes, vertices, the renders by the share of pixels that
            agree); K2 at the renders' launch (16 frames x 64 tiles);
29. preprocess: `preprocess-mead --full-frames --fan-detect --parse-faces`
            with seeded 2DFAN4, S3FD and BiSeNet checkpoints on 2 clips x 32
            frames at 1920x1080, then `--videos` on the same clips through a
            stub ffmpeg: the files, frames/s per stage (S3FD, FAN, the
            warps, EMOCA, BiSeNet); 1 frame card vs CPU, each net's output
            and each warp on the card's own inputs, the files held but where
            a counted near-tie parted the runs; the encoder's transports;
30. bfm: `Visualizer3dmmBfm` on a 70,688-face BFM09-size mesh, 16 frames at
            224^2: K2 once at cap 4096, bit-equal to its plain version with
            no tile over the cap; 2 frames card vs CPU; `D3dfrReconNet` card
            vs CPU;
31. support_nets: `ResNetSE` (SAP, ASP) and `Wav2Vec2SER` on an 8 s clip,
            card vs CPU, K1 12 launches at the shape its encoder saw;
32. train_flint: `train-flint` at FlintConfig() (B=32, T=64): the VAE
            for 50 steps, --vq for 20 and --root (the 18-clip tree) for 6; step
            seconds, peak memory; one step of each mode card vs CPU (the
            2 lr rule, the running statistics within 1e-5) and the
            checkpoint loaded back bit-equal;
33. specaugment: wav2vec2-base with SpecAugment masks (8 s; B=8 over 64
            frames) and with resample=False (8 s, 399 frames): K1 12
            launches each, card vs CPU, the mask moves the output;
34. ablation: the four decoder kinds at EMOTE's widths (flame_bert on the
            full-size FLAME) and the four sequence encoders, card vs CPU;
35. infra: prefetch_to_device onto the card, checkify_step on a planted
            NaN, profile_region in a profiler trace, trace's file,
            ddim_sample_loop(eta=0.5) card vs CPU;
36. parallel: the data- and tensor-parallel layer: `train-prior --dp`
            under `torch.distributed.run --nproc_per_node 1` against the
            command without it; two ranks on this card through gloo: the
            prior step (B=256) and `use_mesh` `generate_batch` (six
            requests) under dp=2, the EMOTE step (B=8, 64 frames) under
            tp=2 with K1 on each rank's 6 heads; a world-1 NCCL group: the
            same serving and prior step, the EMOTE step under tp=1 and
            FSDP2, the neural-loss step with K1 and K2; each held against
            its unsharded run (losses 1e-6 relative);
37. the kernels summary line (K1 at the generate path's, the EMOTE step's,
            the vertex step's and the FaceFormer step's shapes, and its
            bf16 entry at generate --bf16's; K2 at the render path's (under
            the plain and the --flame-npz generate), the neural step's and
            the emotion loss's launches; K3 at the FaceFormer decoder's and
            the vertex decoder's; with the launches of each path that runs
            them; K1 / K3 under the render-loss step; K2 under train-emoca's
            two renders, reconstruct's and the BFM render's; K1 under the SER
            head, at its own shape, and under the masked and resample=False
            wav2vec2 forwards, at theirs; K1 under the tp=2 EMOTE step at a
            rank's 6 heads, K2 under the parallel neural step) and the
            card's name and power limit;
38. the result line.

Each phase prints one JSON line. Any failure raises and the script exits
non-zero without the result line. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
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
        ("emote_train_tp2", 8, 6, 64, 64, 64, (64,) * 8),  # the same step, a tp=2 rank's heads
        ("vert_train", 4, 12, 100, 100, 64, (100,) * 4),  # train-faceformer-vert's step
        ("faceformer_train", 16, 12, 25, 25, 64, (25,) * 16),  # train-faceformer's step
        ("ser_8s", 1, 12, 199, 199, 64, (199,)),  # Wav2Vec2SER on 8 s (399 frames at 25 fps)
        ("w2v_native_8s", 1, 12, 399, 399, 64, (399,)),  # wav2vec2 on 8 s, resample=False
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


def attention_bound_bias_bf16(B, H, T, S, d, bias_bytes, peaks):
    """K3's least time on bfloat16 q, k, v: 4*B*H*T*S*d operations (q.k^T
    and p.v) over the dense bf16 tensor-core peak, or q, k, v and out read
    or written once in bfloat16 and the bias read once as it is stored
    (``bias_bytes``: the FaceFormer family's float32 (H, T, T) or (T, S))
    over the memory rate, whichever is larger."""
    ops = 4 * B * H * T * S * d
    nbytes = 2 * B * H * (2 * T + 2 * S) * d + bias_bytes
    t_ops, t_bytes = ops / peaks[3], nbytes / peaks[1]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), ops, nbytes


def _launch_counts(kb, kba) -> dict:
    return {"keybias_attention": kb.launches, "keybias_attention_bf16": kb.launches_bf16,
            "fused_bias_attention": kba.launches, "fused_bias_attention_bf16": kba.launches_bf16}


def _zero_counts(kb, kba) -> None:
    kb.launches = kb.launches_bf16 = kba.launches = kba.launches_bf16 = 0


# K3 bf16's shapes on the FaceFormer family's bf16 forwards: name, B, H, T = S, d, bias
K3_BF16_CASES = (("forward_self_HTT", 1, 4, 600, 32, "HTT"), ("forward_cross_TS", 1, 4, 600, 32, "TS"),
                 ("train_self_HTT", 16, 4, 25, 32, "HTT"), ("vert_self_HTT_d16", 4, 4, 100, 16, "HTT"))


def k3_bf16_inputs(B, H, T, d, kind, g):
    """bfloat16 q (scaled by d^-1/2), k and v of (B, H, T, d) and the
    decoder's float32 (H, T, T) bias ("HTT", period 25) or (T, S) alignment
    bias ("TS"), S = T, on the card."""
    import torch

    from avi_talking_tpu_torch.ops.positional import enc_dec_alignment_bias, faceformer_bias

    q = (torch.randn(B, H, T, d, device="cuda", generator=g) * d ** -0.5).bfloat16()
    k = torch.randn(B, H, T, d, device="cuda", generator=g).bfloat16()
    v = torch.randn(B, H, T, d, device="cuda", generator=g).bfloat16()
    bias = (faceformer_bias(H, T, 25, device="cuda") if kind == "HTT"
            else enc_dec_alignment_bias(T, T, device="cuda"))
    return q, k, v, bias


def bias_attention_bf16_row(name, B, H, T, d, kind, peaks, g):
    """K3's bfloat16 entry against its plain version on bfloat16 q, k, v
    (B, H, T, d), S = T, with the decoder's float32 (H, T, T) bias ("HTT",
    period 25) or (T, S) alignment bias ("TS"), by ``kb.bf16_disagreement``
    (the same two rounding points as K1's bfloat16 entry: P after its
    normalisation, the output); one bf16 launch and no fp32 one counted. Its
    times: the wrapper's (CUDA events), the kernel's device time, the plain
    version's, and scaled_dot_product_attention's at bfloat16 with the bias
    cast to a bfloat16 mask (timing only: that mask rounds the bias), beside
    the bound at the bf16 peak or the memory rate."""
    import torch
    import torch.nn.functional as F

    from avi_talking_tpu_torch.ops.kernels import bias_attention as kba
    from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb

    S = T
    q, k, v, bias = k3_bf16_inputs(B, H, T, d, kind, g)
    before = (kba.launches, kba.launches_bf16)
    out = kba.fused_bias_attention(q, k, v, bias)
    torch.cuda.synchronize()
    check(out.dtype == torch.bfloat16 and (kba.launches, kba.launches_bf16)
          == (before[0], before[1] + 1), f"fused_bias_attention bf16 {name}: not the bf16 entry")
    ref = kba.fused_bias_attention_reference(q, k, v, bias)
    dis = kb.bf16_disagreement(out, ref)
    check(math.isfinite(dis["max_abs"]) and dis["worst"] <= 1.0 and dis["rms_worst"] <= 1.0,
          f"fused_bias_attention bf16 {name}: {dis} past the limit")
    mask = (bias[None] if bias.dim() == 3 else bias[None, None]).bfloat16()

    def kernel():
        return kba.fused_bias_attention(q, k, v, bias)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)

    row = {"case": name, "shape": [B, H, T, S, d], "dtype": "bfloat16",
           "bias_shape": list(bias.shape), "bias_dtype": "float32",
           "max_abs_err": dis["max_abs"], "limit_share": dis["worst"],
           "rms_limit_share": dis["rms_worst"], "rms_rel": dis["rms_rel"],
           "flipped": dis["flipped"], "ms": time_ms(kernel),
           "device_ms": device_ms(kernel, "keybias_attention_bf16_kernel"),
           "plain_ms": time_ms(lambda: kba.fused_bias_attention_reference(q, k, v, bias)),
           "library_ms": time_ms(library), "library_device_ms": device_ms(library),
           "library": "scaled_dot_product_attention, bfloat16, the bias as a bfloat16 mask"}
    row["bound_ms"], row["bound_by"], row["bf16_ops"], row["bytes"] = attention_bound_bias_bf16(
        B, H, T, S, d, bias.numel() * bias.element_size(), peaks)
    emit({"phase": "kernel_check", "kernel": "fused_bias_attention_bf16", **row})
    return row


def attention_contract_rows(kb, kba):
    """The inputs the Pallas kernels take, through each of the four entries
    (K1 and K3 at float32 and at bfloat16) on the card against its plain
    version: head dims 1, 8, 24, 33, 100 and 128 (the wrapper zero-pads a
    head dim off the kernel's step of 8 or 16 and drops the padding);
    B*H = 65,544 (B=5462 H=12 T=S=8 d=64), past the grid's y limit; and the
    bias of the other dtype (K1 and K3 at bfloat16 with a float32 bias, at
    float32 with a bfloat16 one). Float32 entries within 1e-5 of the plain
    version, bfloat16 ones within ``kb.bf16_disagreement``; each call counted
    on its own entry. The d=8 and B*H cases are timed (wrapper and device),
    with scaled_dot_product_attention beside them on the same inputs (the
    bias as its float mask)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(11)
    entries = {  # name: (wrapper, plain version, q's dtype, the counter it moves)
        "keybias_attention": (kb.keybias_attention, kb.keybias_attention_reference,
                              torch.float32, (kb, "launches")),
        "keybias_attention_bf16": (kb.keybias_attention, kb.keybias_attention_reference,
                                   torch.bfloat16, (kb, "launches_bf16")),
        "fused_bias_attention": (kba.fused_bias_attention, kba.fused_bias_attention_reference,
                                 torch.float32, (kba, "launches")),
        "fused_bias_attention_bf16": (kba.fused_bias_attention,
                                      kba.fused_bias_attention_reference, torch.bfloat16,
                                      (kba, "launches_bf16")),
    }
    cases = [(f"d{d}", 2, 4, 37, 45, d, None) for d in (1, 8, 24, 33, 100, 128)]
    cases.append(("bh_65544", 5462, 12, 8, 8, 64, None))
    cases.append(("other_bias_dtype", 2, 12, 200, 200, 64, "other"))
    rows = []
    for case, B, H, T, S, d, bias_dtype in cases:
        for entry, (fn, plain, dt, (mod, counter)) in entries.items():
            q = (torch.randn(B, H, T, d, device="cuda", generator=g) * d ** -0.5).to(dt)
            k = torch.randn(B, H, S, d, device="cuda", generator=g).to(dt)
            v = torch.randn(B, H, S, d, device="cuda", generator=g).to(dt)
            if entry.startswith("keybias"):
                lens = torch.randint(1, S + 1, (B,), device="cuda", generator=g)
                bias = torch.where(torch.arange(S, device="cuda")[None] < lens[:, None], 0.0, -1e9)
            else:
                bias = torch.randn(H, T, S, device="cuda", generator=g)
                bias = torch.where(torch.rand(H, T, S, device="cuda", generator=g) < 0.2, -1e9,
                                   bias)
            if bias_dtype == "other":
                bias = bias.to(torch.float32 if dt == torch.bfloat16 else torch.bfloat16)
            else:
                bias = bias.to(dt)
            before = _launch_counts(kb, kba)
            out = fn(q, k, v, bias)
            torch.cuda.synchronize()
            moved = {n: c - before[n] for n, c in _launch_counts(kb, kba).items() if c != before[n]}
            check(moved == {entry: 1}, f"{entry} {case}: launches moved {moved}")
            ref = plain(q, k, v, bias)
            row = {"entry": entry, "case": case, "shape": [B, H, T, S, d],
                   "q_dtype": str(dt).split(".")[1], "bias_dtype": str(bias.dtype).split(".")[1]}
            if dt == torch.float32:
                err = float((out - ref).abs().max())
                check(math.isfinite(err) and err < 1e-5, f"{entry} {case}: max |d| {err}")
                row.update({"max_abs_err": err, "tol": 1e-5})
            else:
                dis = kb.bf16_disagreement(out, ref)
                check(math.isfinite(dis["max_abs"]) and dis["worst"] <= 1.0
                      and dis["rms_worst"] <= 1.0, f"{entry} {case}: {dis} past the limit")
                row.update({"max_abs_err": dis["max_abs"], "limit_share": dis["worst"],
                            "rms_limit_share": dis["rms_worst"]})
            if case in ("d8", "bh_65544"):
                kernel_name = ("keybias_attention_bf16_kernel" if dt == torch.bfloat16
                               else "bias_attention_kernel")
                mask = bias[:, None, None, :] if entry.startswith("keybias") else bias[None]

                def library():
                    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)

                row.update({"ms": time_ms(lambda: fn(q, k, v, bias)),
                            "device_ms": device_ms(lambda: fn(q, k, v, bias), kernel_name),
                            "plain_ms": time_ms(lambda: plain(q, k, v, bias), iters=3, reps=3),
                            "library_ms": time_ms(library), "library_device_ms": device_ms(library)})
            rows.append(row)
            del q, k, v, bias, out, ref
    emit({"phase": "attention_contract", "rows": rows})
    return rows


def _in_turns_s(fns: dict, rounds: int) -> dict:
    """Wall seconds of each named call, ``rounds`` times in turns (a, b, a,
    b, ...): {name: [seconds, ...]}."""
    import torch

    out = {n: [] for n in fns}
    for _ in range(rounds):
        for n, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[n].append(time.perf_counter() - t0)
    return out


def _bf16_model_check(label, models, cpu_models, inputs, ar_args, kb, kba, want_fwd, want_pred):
    """One FaceFormer-family model at bfloat16 compute on the card against
    the same weights at float32: the forward's and predict's launches
    (``want_fwd`` / ``want_pred``, the float32 entries 0), finite outputs,
    rms(bf16 - fp32) under 0.1 of rms(fp32) (generate_bf16's rule) for both,
    the card's bf16 forward held to the CPU's by the rule of the CPU tests
    (rms(card bf16 - CPU bf16) < rms(CPU bf16 - CPU fp32)), the distance of
    the teacher-forced pass on predict's own outputs to them (AR vs
    teacher-forced) held within the forward's bf16-to-fp32 distance, and
    wall medians of the forward (5 rounds) and predict (2) at bf16 and fp32
    in turns.
    ``ar_args(model_inputs, T)`` gives predict's arguments and ``tf_on``
    the forward's on its outputs."""
    import torch

    bf16, fp32 = torch.bfloat16, torch.float32
    tf_args, pred_args, tf_on = ar_args
    with torch.no_grad():
        _zero_counts(kb, kba)
        tf16 = models[bf16](*tf_args(inputs))
        torch.cuda.synchronize()
        fwd = _launch_counts(kb, kba)
        _zero_counts(kb, kba)
        ar16 = models[bf16].predict(*pred_args(inputs))
        torch.cuda.synchronize()
        pred = _launch_counts(kb, kba)
        check(fwd == want_fwd, f"{label} bf16 forward launched {fwd}, not {want_fwd}")
        check(pred == want_pred, f"{label} bf16 predict launched {pred}, not {want_pred}")
        check(tf16.dtype == ar16.dtype == bf16, f"{label}: outputs {tf16.dtype}, {ar16.dtype}")
        check(bool(torch.isfinite(tf16).all() and torch.isfinite(ar16).all()),
              f"{label}: non-finite bf16 output")
        tf32 = models[fp32](*tf_args(inputs))
        ar32 = models[fp32].predict(*pred_args(inputs))
        rel = {"forward": _rms(tf16.float().cpu(), tf32.cpu()) / _rms(tf32.cpu()),
               "predict": _rms(ar16.float().cpu(), ar32.cpu()) / _rms(ar32.cpu())}
        check(max(rel.values()) < 0.1, f"{label}: rms(bf16 - fp32) / rms(fp32) {rel} >= 0.1")
        tf_on_ar = models[bf16](*tf_on(inputs, ar16.float()))
        d_ar_tf = _rms(tf_on_ar.float().cpu(), ar16.float().cpu())
        d_fwd = _rms(tf16.float().cpu(), tf32.cpu())
        check(d_ar_tf <= d_fwd, f"{label} bf16: AR vs teacher-forced rms {d_ar_tf} past the "
                                f"forward's bf16-to-fp32 rms {d_fwd}")
        cpu_in = [t.cpu() if torch.is_tensor(t) else t for t in inputs]
        t0 = time.perf_counter()
        cpu16 = cpu_models[bf16](*tf_args(cpu_in))
        cpu16_s = time.perf_counter() - t0
        cpu32 = cpu_models[fp32](*tf_args(cpu_in))
        d_card, d_ref = _rms(tf16.float().cpu(), cpu16.float()), _rms(cpu16.float(), cpu32)
        check(d_card < d_ref, f"{label} bf16 forward, card vs CPU: rms {d_card} not below the "
                              f"CPU's bf16-to-fp32 rms {d_ref}")
        fwd_s = _in_turns_s({"bf16": lambda: models[bf16](*tf_args(inputs)),
                             "fp32": lambda: models[fp32](*tf_args(inputs))}, 5)
        pred_s = _in_turns_s({"bf16": lambda: models[bf16].predict(*pred_args(inputs)),
                              "fp32": lambda: models[fp32].predict(*pred_args(inputs))}, 2)
    return {"forward_launches": fwd, "predict_launches": pred, "finite": True,
            "rms_rel_bf16_to_fp32": rel, "ar_vs_tf_rms": d_ar_tf, "forward_bf16_to_fp32_rms": d_fwd,
            "card_vs_cpu_bf16_rms": d_card, "cpu_bf16_to_fp32_rms": d_ref,
            "cpu_bf16_forward_s": cpu16_s, "max_abs_output": float(tf16.float().abs().max()),
            "forward_wall_s_median": {n: statistics.median(v) for n, v in fwd_s.items()},
            "forward_wall_s_all": fwd_s,
            "predict_wall_s_median": {n: statistics.median(v) for n, v in pred_s.items()},
            "predict_wall_s_all": pred_s}


def _dtype_pair(model) -> dict:
    """``model`` (fp32 compute) and a copy of it at bfloat16 compute: the
    same float32 weights, as JAX's ``dtype=jnp.bfloat16`` over one init."""
    import copy

    import torch

    from avi_talking_tpu_torch.ops.layers import set_compute_dtype

    return {torch.bfloat16: set_compute_dtype(copy.deepcopy(model), torch.bfloat16),
            torch.float32: model}


def phase_faceformer_bf16(kb, kba, peaks):
    """The FaceFormer family at bfloat16 compute (float32 weights, as JAX's
    ``dtype=jnp.bfloat16``), with K3's bfloat16 entry:

    1. K3 bf16 against its plain version at the decoder's shapes (B=1 H=4
       T=S=600 d=32 with the (H, T, T) and (T, S) float32 biases, the
       training step's B=16 T=S=25, the vertex model's B=4 T=S=100 d=16),
       by ``bias_attention_bf16_row``;
    2. the four attention entries on the inputs the Pallas kernels take
       (``attention_contract_rows``);
    3. FaceFormerConfig() on 24 s (B=1, T=600), the weights of the
       ``faceformer`` phase: the forward launches K1 bf16 12 and K3 bf16 2
       times, predict K1 bf16 12 and K3 0, the float32 entries never; the
       rules of ``_bf16_model_check``;
    4. FaceFormerVertConfig() at B=4, T=100 (a zero template), the same;
    5. `train-emote --tiny --bf16`, two steps a stage on the card: the tiny
       wav2vec2's heads are 8 wide (padded to 16 by the wrapper), K1 bf16
       only, finite losses."""
    import copy

    import numpy as np
    import torch

    from avi_talking_tpu_torch.models.faceformer import FaceFormerConfig
    from avi_talking_tpu_torch.models.faceformer_vert import FaceFormerVertConfig

    g = torch.Generator(device="cuda").manual_seed(13)
    k3_rows = [bias_attention_bf16_row(name, B, H, T, d, kind, peaks, g)
               for name, B, H, T, d, kind in K3_BF16_CASES]
    contract = attention_contract_rows(kb, kba)
    bf16, fp32 = torch.bfloat16, torch.float32

    cfg, T = FaceFormerConfig(), 600
    coeff_models = _dtype_pair(_faceformer_model(cfg, seed=0, device="cuda"))
    coeff_cpu = {dt: copy.deepcopy(m).cpu() for dt, m in coeff_models.items()}
    audio, coeffs, eye, emo, ref = _faceformer_inputs(cfg, 1, T, seed=20, device="cuda")
    coeff = _bf16_model_check(
        "FaceFormerCoeff", coeff_models, coeff_cpu, [audio, coeffs, eye, emo, ref],
        (lambda x: x, lambda x: (x[0], T, *x[2:]), lambda x, ar: (x[0], ar, *x[2:])), kb, kba,
        {"keybias_attention": 0, "keybias_attention_bf16": 12, "fused_bias_attention": 0,
         "fused_bias_attention_bf16": 2},
        {"keybias_attention": 0, "keybias_attention_bf16": 12, "fused_bias_attention": 0,
         "fused_bias_attention_bf16": 0})
    del coeff_models, coeff_cpu

    vcfg, B, VT = FaceFormerVertConfig(), 4, 100
    vert_models = _dtype_pair(_vert_model(vcfg, None, seed=0, device="cuda"))
    vert_cpu = {dt: copy.deepcopy(m).cpu() for dt, m in vert_models.items()}
    rng = np.random.default_rng(21)
    vaudio = torch.from_numpy(np.stack([synthetic_wav(VT / 25.0, 30 + i)
                                        for i in range(B)]).astype(np.float32)).cuda()
    verts = torch.from_numpy((rng.standard_normal((B, VT, vcfg.vertice_dim)) * 0.01)
                             .astype(np.float32)).cuda()
    vemo = torch.from_numpy(rng.standard_normal((B, VT, vcfg.emo_dim)).astype(np.float32)).cuda()
    vert = _bf16_model_check(
        "FaceFormerVert", vert_models, vert_cpu, [vaudio, verts, vemo],
        (lambda x: x, lambda x: (x[0], VT, x[2]), lambda x, ar: (x[0], ar, x[2])), kb, kba,
        {"keybias_attention": 0, "keybias_attention_bf16": 12, "fused_bias_attention": 0,
         "fused_bias_attention_bf16": 2},
        {"keybias_attention": 0, "keybias_attention_bf16": 12, "fused_bias_attention": 0,
         "fused_bias_attention_bf16": 0})
    del vert_models, vert_cpu

    _zero_counts(kb, kba)
    out, _, cli_s = _run_cli(["train-emote", "--tiny", "--bf16", "--steps", "2",
                              "--val-every", "2"])
    tiny_launches = _launch_counts(kb, kba)
    done = [line for line in out.splitlines() if line.startswith("done:")]
    check(len(done) == 1 and math.isfinite(float(done[0].rsplit(" ", 1)[1])),
          f"train-emote --tiny --bf16 printed {out[-2000:]!r}")
    check(tiny_launches["keybias_attention_bf16"] > 0 and tiny_launches["keybias_attention"] == 0,
          f"train-emote --tiny --bf16 launched {tiny_launches}")
    row = {"phase": "faceformer_bf16", "k3_bf16_rows": [r["case"] for r in k3_rows],
           "faceformer": {"config": "FaceFormerConfig()", "batch": 1, "frames": T, **coeff},
           "faceformer_vert": {"config": "FaceFormerVertConfig()", "batch": B, "frames": VT,
                               **vert},
           "train_emote_tiny_bf16": {"argv": "train-emote --tiny --bf16 --steps 2 --val-every 2",
                                     "launches": tiny_launches, "done": done[0],
                                     "wall_s": cli_s}}
    emit(row)
    return {"k3_rows": k3_rows, "contract": contract, "coeff": coeff, "vert": vert,
            "tiny_launches": tiny_launches}


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
# video moved this gradient by 2.4e-4 on the CPU alone (PERF.md §6; no
# longer measured on each run, to keep the run inside its time); twice
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


def _neural_chain(neural, verts, gt_video, batch, perm, backward=True):
    """The neural terms of predicted ``verts`` (2B, T, V, 3) against the
    rendered ``gt_video`` (B, T, H, W, 3) on ``neural``'s device: render,
    towers, losses; with ``backward`` also the gradient of the loss in the
    vertices and in the rendered video."""
    import torch

    dev = neural.renderer.device
    v = verts.to(dev).clone().requires_grad_(backward)
    with torch.set_grad_enabled(backward):
        video = neural.render_video(v)
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
    2. One neural step at B=2, 8 frames (one latent frame) on the card, its
       parts held on the CPU from the same weights and exchange permutation,
       the CPU rendering through the same route (K2's plain version): the
       card's weights within lr / 100 (+ 1e-6 |w|) of AdamW on the CPU with
       the card's gradients; the CPU's head stepped with the neural terms'
       value and gradient taken from the card, by ``one_step_card_vs_cpu``
       as it stands (loss, weights, gradients), its predicted vertices
       within 1e-4 of the card's, with the pixels whose winning face
       changed between the two.
    3. Identical vertices on both sides (the card's predicted ones):
       winners equal, every term within 1e-4, the render's backward from
       one image gradient within 1e-4; the vertex gradient through render and towers
       within ``VERTEX_GRAD_REL`` of its largest. The towers run once on
       the CPU, here.
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

    # (2) one step on the card, its parts held on the CPU; T=8 keeps the CPU's
    # ResNet-50 at 224^2 short. The CPU runs the towers once, in (3).
    assets = neural_assets(tiny=False)
    cfg = EmoteConfig()
    n_exp, n_shape = cfg.flint.n_exp, cfg.n_shape
    batch = next(synthetic_batches(np.random.default_rng(1), B, 8, n_exp, n_shape, "cpu"))
    perm = torch.tensor([1, 0])
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    head = build_head(False, seed=2, device=cuda, flame_assets=assets)
    suites = {"cuda": build_neural(False, assets.faces, cuda),
              "cpu": build_neural(False, assets.faces, cpu)}
    suites["cpu"].renderer = _kernel_route_renderer(assets.faces, 224, cpu)  # K2's plain version
    suites["cuda"].loss, card = _recording(suites["cuda"].loss)
    t0 = time.perf_counter()
    m = _neural_trainer(head, suites["cuda"], lr).train_step(
        {k: v.to(cuda) for k, v in batch.items()}, perm=perm)
    metrics = {"cuda": {k: float(v) for k, v in m.items()}, "cuda_step_s": time.perf_counter() - t0}
    card_step = (metrics["cuda"]["loss"], _trained(head))
    grads = {k: t.grad.cpu() for k, t in card_step[1].items() if t.grad is not None}
    verts = card["vertices"]  # the card's predicted vertices
    # the card's update: AdamW on the CPU from the same initial weights with
    # the card's gradients; a skipped, sign-flipped or mis-scaled step moves
    # a weight by lr or more
    head = build_head(False, seed=2, device=cpu, flame_assets=assets)
    init = {k: t.detach().clone() for k, t in _trained(head).items()}
    replay = _replay(init, grads, functools.partial(adamw, lr=lr))
    update = {"max_abs_diff": max(float((card_step[1][k].detach().cpu() - w).abs().max())
                                  for k, w in replay.items()),
              "max_abs_diff_over_limit": max(
                  float(((card_step[1][k].detach().cpu() - w).abs()
                         / (lr / 100 + 1e-6 * w.abs())).max()) for k, w in replay.items())}
    # the head's step on the CPU under the card's neural gradient: the neural
    # terms replaced by their value and their gradient at the vertices on the
    # card; the training steps' rule as it stands (one_step_card_vs_cpu), and the CPU's
    # predicted vertices against the card's
    cpu_verts = {}

    def card_neural(v, *args):
        cpu_verts["v"] = v.detach().clone()
        lin = (v * card["cotangent"]).sum()
        return lin - lin.detach() + card["value"]
    stand_in = types.SimpleNamespace(any_enabled=lambda: True, loss=card_neural)
    t0 = time.perf_counter()
    m = _neural_trainer(head, stand_in, lr).train_step(batch, perm=perm)
    metrics["cpu_head_step_s"] = time.perf_counter() - t0
    metrics["cpu"] = {k: float(v) for k, v in m.items()}
    head_step = one_step_card_vs_cpu({"cuda": card_step, "cpu": (float(m["loss"]), _trained(head))},
                                     lr=lr, loss_tol=1e-4 * abs(metrics["cuda"]["loss"]))
    vert_err = _max_rel(verts, cpu_verts["v"])
    renderers = {d: s.renderer for d, s in suites.items()}
    # K2 on both sides' vertices, for the pixels that changed winner
    changed = (_view_winners(renderers["cuda"], verts.cuda().flatten(0, 1))
               != _view_winners(renderers["cuda"], cpu_verts["v"].cuda().flatten(0, 1)))
    winners_changed = int(changed.sum())
    in_mouth = int(renderers["cpu"].crop_mouth(changed[..., None]).sum())
    # the batch's gt vertices, decoded as the trainer decodes them, rendered once a side
    jaw = batch["gt_jaw"].reshape(B * 8, 3)
    gt = FlameModel(assets, n_shape=n_shape, n_exp=n_exp).vertices_only(
        torch.zeros(B * 8, n_shape), batch["gt_exp"].reshape(B * 8, n_exp),
        torch.cat([torch.zeros_like(jaw), jaw], -1)).reshape(B, 8, -1, 3)
    with torch.no_grad():
        gt_video = {d: suites[d].render_video(gt.to(d)) for d in ("cuda", "cpu")}

    # (3) identical vertices (the card's predicted ones) on both sides:
    # winners, terms, the vertex gradient through render and towers; and the
    # card's render backward from the CPU's image gradient (on the CPU that
    # is the chain's own vertex gradient)
    winners = {d: _view_winners(renderers[d], verts.to(d).flatten(0, 1)) for d in ("cuda", "cpu")}
    t0 = time.perf_counter()
    chain = {d: _neural_chain(suites[d], verts, gt_video[d], batch, perm)
             for d in ("cuda", "cpu")}
    metrics["chain_s_both_sides"] = time.perf_counter() - t0
    v = verts.cuda().requires_grad_()
    (suites["cuda"].render_video(v) * chain["cpu"]["video_grad"].cuda()).sum().backward()
    vg = {d: c["vertex_grad"] for d, c in chain.items()}
    same = {"winners_differing": int((winners["cuda"] != winners["cpu"]).sum()),
            "terms_rel_diff": _rel(chain["cuda"]["terms"], chain["cpu"]["terms"]),
            "vertex_grad_rel": _max_rel(vg["cuda"], vg["cpu"]),
            "vertex_grad_l2_rel": float((vg["cuda"] - vg["cpu"]).norm() / vg["cpu"].norm()),
            "vertex_grad_limit": VERTEX_GRAD_REL,
            "video_grad_rel": _max_rel(chain["cuda"]["video_grad"], chain["cpu"]["video_grad"]),
            "render_backward_vertex_grad_rel": _max_rel(v.grad.cpu(), vg["cpu"])}
    one_step = {"update_vs_adamw_on_the_cards_gradients": update,
                "head_step_under_the_cards_neural_gradient": head_step}
    emit({"phase": "train_emote_neural_card_vs_cpu",
          "one_step": {"predicted_vertices_rel_diff": vert_err,
                       "pixels_changed_winner": winners_changed,
                       "of_them_in_the_mouth_crop": in_mouth, **one_step},
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
          f"{same['vertex_grad_rel']} of its largest, past {VERTEX_GRAD_REL}")
    check(vert_err < 1e-4, f"one neural step: predicted vertices differ by {vert_err} of the "
          "largest")
    check(update["max_abs_diff_over_limit"] <= 1.0,
          f"one neural step: the card's weights lie {update['max_abs_diff']} from AdamW on its "
          f"own gradients, past lr / 100 + 1e-6 |w|")
    del card_step, suites, renderers, chain, head, gt_video, grads, replay

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
          "gpu_vs_cpu_one_step_B2_T8": {"metrics": metrics,
                                        "predicted_vertices_rel_diff": vert_err,
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


def attention_backward_bound_bf16(B, H, T, S, d, peaks):
    """K1's bfloat16 backward's least time: the recompute's five (T, S, d)
    products (the scores, dv, dw, dq, dk), 10*B*H*T*S*d operations, at the
    fp32 peak, as the float32 recompute does them (three of the five take a
    float32 operand); or q, k, v, do and the (B, S) key bias read once and
    dq, dk, dv written once, all bfloat16, over the memory rate."""
    flops = 10 * B * H * T * S * d
    nbytes = 2 * B * H * (3 * T + 3 * S) * d + 2 * B * S
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_attention_grad_bf16(peaks):
    """K1's gradient at bfloat16 at `train-emote --bf16`'s step (B=8 H=12
    T=S=64 d=64): the bfloat16 kernel's forward and the recompute backward
    (float32, each gradient cast to bfloat16, as JAX's ``_keybias_bwd``) on
    the card against the same wrapper on CPU copies (the plain forward), each
    gradient within ``kb.bf16_disagreement``'s limit (both sides round
    float32 values that differ only in summation order); one bfloat16 launch
    on the card, none in fp32. The backward's time (CUDA events, device ms)
    beside its bound, the plain version's backward (autograd through the
    bfloat16 plain forward) and scaled_dot_product_attention's backward at
    bfloat16 with the same float mask."""
    import torch
    import torch.nn.functional as F

    from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb

    B, H, T, d = 8, 12, 64, 64
    S = T
    g = torch.Generator().manual_seed(6)
    q = (torch.randn(B, H, T, d, generator=g) * d ** -0.5).bfloat16()
    k = torch.randn(B, H, S, d, generator=g).bfloat16()
    v = torch.randn(B, H, S, d, generator=g).bfloat16()
    cot = torch.randn(B, H, T, d, generator=g).bfloat16()
    bias = torch.zeros(B, S, dtype=torch.bfloat16)
    grads, launched = {}, {}
    for dev in ("cpu", "cuda"):
        ts = [t.to(dev, copy=True).requires_grad_(i < 3) for i, t in enumerate((q, k, v, bias))]
        kb.launches = kb.launches_bf16 = 0
        torch.autograd.backward(kb.keybias_attention(*ts), cot.to(dev))
        launched[dev] = {"fp32": kb.launches, "bf16": kb.launches_bf16}
        grads[dev] = [t.grad.cpu() for t in ts[:3]]
    check(launched == {"cpu": {"fp32": 0, "bf16": 0}, "cuda": {"fp32": 0, "bf16": 1}},
          f"K1's bf16 gradient launched {launched}")
    dis = {n: kb.bf16_disagreement(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads["cuda"],
                                                              grads["cpu"])}
    for n, x in dis.items():
        check(x["worst"] <= 1.0 and x["rms_worst"] <= 1.0,
              f"K1 bf16 gradient {n}, card vs CPU: {x} past the limit")
    qc, kc, vc = (t.cuda().requires_grad_() for t in (q, k, v))
    bc, cc = bias.cuda(), cot.cuda()

    def bwd_ms(out):
        return time_ms(lambda: torch.autograd.grad(out, (qc, kc, vc), cc, retain_graph=True))

    out = kb.keybias_attention(qc, kc, vc, bc)
    row = {"kernel": "keybias_attention_bf16", "shape": [B, H, T, S, d], "dtype": "bfloat16",
           "bias_shape": [B, S], "path": "train-emote --bf16 (backward, 12 a step)",
           "max_abs_err": {n: x["max_abs"] for n, x in dis.items()},
           "limit_share": max(x["worst"] for x in dis.values()),
           "rms_limit_share": max(x["rms_worst"] for x in dis.values()),
           "backward_ms": bwd_ms(out),
           # every device kernel of the backward, summed
           "backward_device_ms": device_ms(
               lambda: torch.autograd.grad(out, (qc, kc, vc), cc, retain_graph=True)),
           "plain_backward_ms": bwd_ms(kb.keybias_attention_reference(qc, kc, vc, bc)),
           "library_backward_ms": bwd_ms(F.scaled_dot_product_attention(
               qc, kc, vc, attn_mask=bc[:, None, None, :], scale=1.0))}
    lib_out = F.scaled_dot_product_attention(qc, kc, vc, attn_mask=bc[:, None, None, :], scale=1.0)
    row["library_backward_device_ms"] = device_ms(
        lambda: torch.autograd.grad(lib_out, (qc, kc, vc), cc, retain_graph=True))
    row["bound_ms"], row["bound_by"] = attention_backward_bound_bf16(B, H, T, S, d, peaks)
    emit({"phase": "attention_grads", **row})
    return row


def _grads_rms_rel(got: dict, ref: dict) -> dict:
    """rms(got - ref) / rms(ref) of each trained tensor's gradient, and of
    all of them together (``"all"``), the key biases left out: their exact
    gradient is 0 (softmax is shift invariant along a key row), so theirs
    is rounding noise (wav2vec2's ``k_proj.bias``, the key third of each
    packed ``in_proj_bias``)."""
    import torch

    out, num, den = {}, 0.0, 0.0
    for k, r in ref.items():
        if k.endswith("k_proj.bias"):
            continue
        a, b = got[k].double().flatten().cpu(), r.double().flatten().cpu()
        if k.endswith("in_proj_bias"):
            n = a.numel() // 3
            a, b = torch.cat([a[:n], a[2 * n:]]), torch.cat([b[:n], b[2 * n:]])
        out[k] = float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt().clamp_min(1e-30))
        num, den = num + float((a - b).pow(2).sum()), den + float(b.pow(2).sum())
    out["all"] = (num / den) ** 0.5
    return out


# bf16 against fp32, the step's gradient: all of it within 0.1 of its rms
# (PERF.md §2's bfloat16 rule), each tensor within 0.2. A tensor's own rms
# can pass 0.1 where its exact gradient cancels: the query and key
# projections of the deepest wav2vec2 layers take theirs through the score
# gradient ds = w (dw - sum(dw w)), formed from bfloat16 q, k, v and do (as
# JAX's _keybias_bwd forms it): 0.09-0.12 on the card, the rest at most
# 0.075 (PERF.md §6).
GRAD_BF16_ALL, GRAD_BF16_TENSOR = 0.1, 0.2


def _loss_and_grads(trainer, batch, perm=None) -> dict:
    """One forward and backward of ``trainer`` on ``batch`` (no update):
    the metrics, each trained tensor's gradient and the K1 launches by
    dtype."""
    from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb

    trainer.optimizer.zero_grad(set_to_none=True)
    kb.launches = kb.launches_bf16 = 0
    loss, metrics = trainer.loss_fn(batch, perm=perm)
    loss.backward()
    return {"metrics": {k: float(v.detach()) for k, v in metrics.items()},
            "grads": {k: t.grad.detach().clone() for k, t in _trained(trainer.head).items()
                      if t.grad is not None},
            "k1": {"fp32": kb.launches, "bf16": kb.launches_bf16}}


def _vector(metrics: dict, grads: dict):
    """The metrics and the gradients but the key biases', in one float64
    vector (the rule's operand)."""
    import torch

    parts = [torch.tensor([metrics[k] for k in sorted(metrics)], dtype=torch.float64)]
    for k in sorted(grads):
        if k.endswith("k_proj.bias"):
            continue
        g = grads[k].double().flatten().cpu()
        if k.endswith("in_proj_bias"):
            n = g.numel() // 3
            g = torch.cat([g[:n], g[2 * n:]])
        parts.append(g)
    return torch.cat(parts)


def _in_turns(trainers: dict, batch, rounds: int = 3, **kw) -> dict:
    """Each of ``trainers`` ({"fp32": ..., "bf16": ...}) stepped on
    ``batch`` in turns (fp32, bf16, bf16, fp32, ``rounds`` times, the first
    round a warm-up): seconds per step and peak memory of each."""
    import torch

    walls = {k: [] for k in trainers}
    peak = {k: 0.0 for k in trainers}
    for order in (("fp32", "bf16"), ("bf16", "fp32")) * rounds:
        for which in order:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainers[which].train_step(batch, **kw)
            torch.cuda.synchronize()
            walls[which].append(time.perf_counter() - t0)
            peak[which] = max(peak[which], torch.cuda.max_memory_allocated() / 2 ** 30)
    return {"step_s_median": {k: statistics.median(v[2:]) for k, v in walls.items()},
            "step_s_all": walls, "peak_allocated_gib": peak,
            "order": "fp32, bf16, bf16, fp32, repeated; the first two steps of each a warm-up"}


def phase_train_emote_bf16(kb):
    """`train-emote --bf16`: the head at bfloat16 compute over float32
    weights, at full width and the command's defaults (B=8, 64 frames).

    1. The command, two stages of 3 steps with validation every 3: K1's
       bfloat16 entry 12 times a forward (2 x (3 steps + 2 validation
       batches) x 12 = 120), the float32 one never; a finite validation loss.
    2. Steps stepped directly: 12 bfloat16 launches a step and 0 fp32.
    3. A bf16 step against an fp32 step on the card, from the same weights
       and batch: the whole gradient within 0.1 of the fp32 gradient's rms
       (PERF.md §2's bfloat16 rule), each trained tensor's within 0.2
       (``GRAD_BF16_TENSOR``; the key biases, whose exact gradient is 0,
       left out), the loss within 0.1 relative; the two trainers' steps in
       turns with their peak memory.
    4. The card at bf16 against the CPU at bf16 at the tiny width (its
       wav2vec2 at 64 wide with 4 heads: the tiny config's head width of 8
       is below the bfloat16 kernel's step of 16): one step's metrics and
       gradients, by the rule of the CPU tests: rms(card bf16 - CPU bf16) <
       rms(CPU bf16 - CPU fp32)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from avi_talking_tpu_torch.audio.wav2vec2 import Wav2Vec2Config
    from avi_talking_tpu_torch.cli import main as cli_main
    from avi_talking_tpu_torch.cli.train_emote import build_head, synthetic_batches
    from avi_talking_tpu_torch.infra.init import random_module
    from avi_talking_tpu_torch.models.emote import EmoteConfig, EmoteTalkingHead

    B, T, lr, steps = 8, 64, 1e-4, 3
    bf16, fp32, dev = torch.bfloat16, torch.float32, torch.device("cuda")
    buf = io.StringIO()
    kb.launches = kb.launches_bf16 = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["train-emote", "--bf16", "--steps", str(steps), "--val-every", str(steps)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = {"fp32": kb.launches, "bf16": kb.launches_bf16}
    check(rc == 0, f"train-emote --bf16 exited {rc}")
    want = {"fp32": 0, "bf16": 12 * 2 * (steps + 2)}
    check(cli_launches == want, f"train-emote --bf16 launched K1 {cli_launches}, not {want}")
    done = [line for line in buf.getvalue().splitlines() if line.startswith("done:")]
    check(len(done) == 1 and math.isfinite(float(done[0].rsplit(" ", 1)[1])),
          f"train-emote --bf16 printed {buf.getvalue()!r}")

    cfg = EmoteConfig()
    draw = (cfg.flint.n_exp, cfg.n_shape)
    head = build_head(False, seed=0, device=dev, dtype=bf16)
    trainer = _emote_trainer(head, lr)
    batches = synthetic_batches(np.random.default_rng(0), B, T, *draw, "cuda")
    per_step, losses = [], []
    for _ in range(4):
        kb.launches = kb.launches_bf16 = 0
        losses.append(float(trainer.train_step(next(batches))["loss"]))
        per_step.append({"fp32": kb.launches, "bf16": kb.launches_bf16})
    check(per_step == [{"fp32": 0, "bf16": 12}] * 4,
          f"train-emote --bf16 steps launched K1 {per_step}")
    check(all(math.isfinite(x) for x in losses), f"bf16 EMOTE losses {losses}")
    del trainer, head

    batch = next(synthetic_batches(np.random.default_rng(1), B, T, *draw, "cuda"))
    trainers = {n: _emote_trainer(build_head(False, seed=2, device=dev, dtype=dt), lr)
                for n, dt in (("fp32", fp32), ("bf16", bf16))}
    got = {n: _loss_and_grads(tr, batch) for n, tr in trainers.items()}
    check(got["fp32"]["k1"] == {"fp32": 12, "bf16": 0} and got["bf16"]["k1"] == {"fp32": 0,
                                                                                "bf16": 12},
          f"K1 launches of the compared steps: {got['fp32']['k1']}, {got['bf16']['k1']}")
    grad_rel = _grads_rms_rel(got["bf16"]["grads"], got["fp32"]["grads"])
    worst = max((k for k in grad_rel if k != "all"), key=grad_rel.get)
    loss_rel = abs(got["bf16"]["metrics"]["loss"] - got["fp32"]["metrics"]["loss"]) / abs(
        got["fp32"]["metrics"]["loss"])
    timing = _in_turns(trainers, batch)
    del trainers, got

    small = dataclasses.replace(EmoteConfig.tiny(), wav2vec2=Wav2Vec2Config.tiny(hidden=64, heads=4))
    tb = next(synthetic_batches(np.random.default_rng(2), 2, 16, small.flint.n_exp, small.n_shape,
                                "cpu"))
    sides = {}
    for name, d, dt in (("card_bf16", "cuda", bf16), ("cpu_bf16", "cpu", bf16),
                        ("cpu_fp32", "cpu", fp32)):
        h = random_module(lambda: EmoteTalkingHead(small, condition_dim=9 + 3 + 32 + small.n_shape,
                                                   dtype=dt),
                          torch.device(d), torch.Generator().manual_seed(3))
        r = _loss_and_grads(_emote_trainer(h, lr), {k: v.to(d) for k, v in tb.items()})
        sides[name] = _vector(r["metrics"], r["grads"])
    d_card = float((sides["card_bf16"] - sides["cpu_bf16"]).pow(2).mean().sqrt())
    d_ref = float((sides["cpu_bf16"] - sides["cpu_fp32"]).pow(2).mean().sqrt())
    emit({"phase": "train_emote_bf16", "config": "EmoteConfig() at bfloat16 compute",
          "batch": B, "frames": T, "lr": lr,
          "cli": f"train-emote --bf16 --steps {steps} --val-every {steps}", "cli_wall_s": cli_s,
          "cli_k1_launches": cli_launches, "final": done[0], "k1_launches_per_step": per_step,
          "losses": losses, "bf16_vs_fp32_one_step": {
              "grad_rms_rel": grad_rel, "grad_rms_rel_all": grad_rel["all"],
              "grad_rms_rel_worst": grad_rel[worst], "grad_rms_rel_worst_tensor": worst,
              "tensors_past_0.1": sorted(k for k, v in grad_rel.items() if v >= 0.1),
              "loss_rel": loss_rel,
              "limits": {"all": GRAD_BF16_ALL, "tensor": GRAD_BF16_TENSOR, "loss": 0.1}},
          "in_turns": timing,
          "card_vs_cpu_bf16_tiny": {"config": "EmoteConfig.tiny(), wav2vec2 64 wide, 4 heads",
                                    "rms_card_bf16_to_cpu_bf16": d_card,
                                    "rms_cpu_bf16_to_cpu_fp32": d_ref}})
    check(grad_rel["all"] < GRAD_BF16_ALL and grad_rel[worst] < GRAD_BF16_TENSOR
          and loss_rel < 0.1,
          f"train-emote --bf16 against fp32: the gradient {grad_rel['all']} of its rms (limit "
          f"{GRAD_BF16_ALL}), {worst}'s {grad_rel[worst]} (limit {GRAD_BF16_TENSOR}), loss "
          f"{loss_rel} (limit 0.1)")
    check(d_card < d_ref, f"tiny bf16 step, card vs CPU: rms {d_card} not below the CPU's bf16 to "
          f"fp32 {d_ref}")
    return {"launches": cli_launches["bf16"]}


def phase_train_emote_neural_bf16(kb, kras):
    """`train-emote --neural --bf16`: the head and the three towers at
    bfloat16 compute, the renders in float32 (K2 unchanged), at full width.

    1. The command at B=2, 32 frames, two stages of 2 steps, validation every
       2: K1's bfloat16 entry 12 a forward (2 x (2 + 2) x 12 = 96), fp32 0;
       K2 2 a neural loss (2 x (2 + 2) = 8); a finite validation loss.
    2. bf16 against fp32 on the card from the same weights, batch and
       exchange: the step's loss within 0.1 relative; and at identical
       predicted vertices (the fp32 head's) the gradient of the neural terms
       at the vertices, through the render and the towers, within 0.1 of the
       fp32 gradient's rms (PERF.md §2's bfloat16 rule), each term's distance
       reported.
    3. The two trainers' steps at B=2, 32 frames in turns, with K2's
       launches and peak memory; then one bf16 step at the command's
       defaults (B=8, 64 frames), which fp32 cannot take in 80 GiB (PERF.md §5):
       its peak memory, or the allocator's refusal, is recorded and not
       held."""
    import contextlib
    import gc
    import io

    import numpy as np
    import torch

    from avi_talking_tpu_torch.cli import main as cli_main
    from avi_talking_tpu_torch.cli.train_emote import (
        build_head, build_neural, neural_assets, synthetic_batches)
    from avi_talking_tpu_torch.core.flame import FlameModel
    from avi_talking_tpu_torch.models.emote import EmoteConfig

    B, T, lr, steps = 2, 32, 1e-4, 2
    bf16, fp32, dev = torch.bfloat16, torch.float32, torch.device("cuda")
    buf = io.StringIO()
    kb.launches = kb.launches_bf16 = kras.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["train-emote", "--neural", "--bf16", "--batch-size", str(B), "--frames",
                       str(T), "--steps", str(steps), "--val-every", str(steps)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = {"keybias_attention": kb.launches, "keybias_attention_bf16": kb.launches_bf16,
                    "rasterize_tiles_visibility": kras.launches}
    check(rc == 0, f"train-emote --neural --bf16 exited {rc}")
    want = {"keybias_attention": 0, "keybias_attention_bf16": 12 * 2 * (steps + 2),
            "rasterize_tiles_visibility": 2 * (steps + 2)}
    check(cli_launches == want, f"train-emote --neural --bf16 launched {cli_launches}, not {want}")
    done = [line for line in buf.getvalue().splitlines() if line.startswith("done:")]
    check(len(done) == 1 and math.isfinite(float(done[0].rsplit(" ", 1)[1])),
          f"train-emote --neural --bf16 printed {buf.getvalue()!r}")

    assets = neural_assets(tiny=False)
    cfg = EmoteConfig()
    n_exp, n_shape = cfg.flint.n_exp, cfg.n_shape
    batch = next(synthetic_batches(np.random.default_rng(1), B, T, n_exp, n_shape, "cuda"))
    perm = torch.tensor([1, 0])
    suites, trainers, got, seen = {}, {}, {}, {}
    for name, dt in (("fp32", fp32), ("bf16", bf16)):
        head = build_head(False, seed=2, device=dev, flame_assets=assets, dtype=dt)
        suites[name] = build_neural(False, assets.faces, dev, dtype=dt)
        suites[name].loss, seen[name] = _recording(suites[name].loss)
        trainers[name] = _neural_trainer(head, suites[name], lr)
        kras.launches = 0
        got[name] = _loss_and_grads(trainers[name], batch, perm=perm)
        got[name]["k2"] = kras.launches
    check(got["bf16"]["k1"] == {"fp32": 0, "bf16": 12} and got["bf16"]["k2"] == 2,
          f"the neural bf16 step launched K1 {got['bf16']['k1']}, K2 {got['bf16']['k2']}")
    loss_rel = abs(got["bf16"]["metrics"]["loss"] - got["fp32"]["metrics"]["loss"]) / abs(
        got["fp32"]["metrics"]["loss"])
    terms_rel = {k: abs(got["bf16"]["metrics"][k] - v) / max(abs(v), 1e-12)
                 for k, v in got["fp32"]["metrics"].items()}
    # identical vertices: the fp32 head's prediction, through each suite
    verts = seen["fp32"]["vertices"]
    jaw = batch["gt_jaw"].reshape(B * T, 3)
    gt = FlameModel(assets.to(dev), n_shape=n_shape, n_exp=n_exp).vertices_only(
        torch.zeros(B * T, n_shape, device=dev), batch["gt_exp"].reshape(B * T, n_exp),
        torch.cat([torch.zeros_like(jaw), jaw], -1)).reshape(B, T, -1, 3)
    with torch.no_grad():
        gt_video = suites["fp32"].render_video(gt)
    chain = {n: _neural_chain(suites[n], verts, gt_video, batch, perm) for n in suites}
    vg = {n: c["vertex_grad"].double() for n, c in chain.items()}
    vertex_grad_rel = float((vg["bf16"] - vg["fp32"]).pow(2).mean().sqrt()
                            / vg["fp32"].pow(2).mean().sqrt())
    chain_terms_rel = _rel(chain["bf16"]["terms"], chain["fp32"]["terms"])
    del chain, vg, got
    kras.launches = 0
    timing = _in_turns(trainers, batch, perm=perm)
    timing["k2_launches"] = kras.launches
    del trainers, suites, seen
    gc.collect()
    torch.cuda.empty_cache()

    # the command's defaults at bf16: recorded, not held
    defaults = {"batch": 8, "frames": 64}
    try:
        head = build_head(False, seed=0, device=dev, flame_assets=assets, dtype=bf16)
        trainer = _neural_trainer(head, build_neural(False, assets.faces, dev, dtype=bf16), lr)
        big = next(synthetic_batches(np.random.default_rng(0), 8, 64, n_exp, n_shape, "cuda"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = float(trainer.train_step(
            big, generator=torch.Generator(device="cuda").manual_seed(0))["loss"])
        torch.cuda.synchronize()
        defaults.update(fits=True, step_s=time.perf_counter() - t0, loss=loss,
                        peak_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    except torch.cuda.OutOfMemoryError as e:
        defaults.update(fits=False, refused=str(e).splitlines()[0])
    trainer = head = big = None
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_emote_neural_bf16",
          "config": "EmoteConfig() and the towers at bfloat16 compute, synthetic FLAME 5023 / "
                    "9976, 224^2 float32 renders",
          "batch": B, "frames": T, "lr": lr,
          "cli": f"train-emote --neural --bf16 --batch-size {B} --frames {T} --steps {steps} "
                 f"--val-every {steps}",
          "cli_wall_s": cli_s, "cli_launches": cli_launches, "final": done[0],
          "bf16_vs_fp32": {"loss_rel": loss_rel, "metrics_rel": terms_rel,
                           "identical_vertices": {"vertex_grad_rms_rel": vertex_grad_rel,
                                                  "terms_rel": chain_terms_rel},
                           "limit": 0.1},
          "in_turns": timing, "defaults_at_bf16": defaults})
    check(loss_rel < 0.1 and vertex_grad_rel < 0.1,
          f"train-emote --neural --bf16 against fp32: loss {loss_rel}, vertex gradient "
          f"{vertex_grad_rel} of its rms; the limit is 0.1")
    return {"launches": cli_launches}


def _png_with_filter(path, filter_type: int, size: int = 224, seed: int = 0):
    """A size^2 RGB PNG whose rows all carry ``filter_type`` (random
    filtered bytes: any byte string is a valid filtered row)."""
    import struct
    import zlib

    import numpy as np

    rows = np.random.default_rng(seed + filter_type).integers(0, 256, (size, size * 3),
                                                              dtype=np.uint8)
    raw = b"".join(bytes([filter_type]) + r.tobytes() for r in rows)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", size, size, 8, 2, 0,
                                                                   0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    return path


def phase_host_codecs():
    """The host codecs of ``native/`` on the card's host: wavio.cpp and
    imageio.cpp built by g++ at first use into build/ (seconds each), then
    held to the Python versions of the port: a 16 kHz wav decode within
    1e-4 (as the JAX package's native test), a 48 kHz one resampled to 16
    kHz still a 440 Hz sine of the same rms, the framing equal; the PNG
    decode bit-equal on the golden file with all five row filters and on a
    224^2 crop under each filter, with the decode's milliseconds per crop
    native and Python (S2b's cost)."""
    import tempfile
    import wave

    import numpy as np

    from avi_talking_tpu_torch.audio import frontend, native
    from avi_talking_tpu_torch.infra import native_build
    from avi_talking_tpu_torch.viz import pngio

    build = {}
    for name, load in (("wavio", native._load), ("imageio", pngio._load_native)):
        path = native_build.library_path(name)
        fresh = not path.exists()
        t0 = time.perf_counter()
        load()
        build[name] = {"library": os.path.relpath(path, HERE), "built_here": fresh,
                       "seconds": time.perf_counter() - t0}
    lib = pngio._load_native()
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        def write_wav(path, sr, data):
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sr)
                w.writeframes((data * 32767).astype("<i2").tobytes())

        p16 = os.path.join(tmp, "a.wav")
        write_wav(p16, 16000, synthetic_wav(8.0, seed=4))
        got, _ = native.read_wav_native(p16)
        want, _ = frontend.read_wav(p16)
        wav_err = float(np.abs(got - want).max()) if got.shape == want.shape else math.inf
        check(wav_err < 1e-4, f"native wav decode: max |d| {wav_err} from the Python decoder")
        frames_equal = bool(np.array_equal(native.frame_audio_native(got),
                                           frontend.frame_audio(got)))
        check(frames_equal, "frame_audio_native differs from frame_audio")
        p48 = os.path.join(tmp, "b.wav")
        write_wav(p48, 48000, (np.sin(2 * np.pi * 440 * np.arange(48000) / 48000) * 0.5
                               ).astype(np.float32))
        r48, sr = native.read_wav_native(p48)
        rms48, zc = float(np.sqrt((r48 ** 2).mean())), int(np.sum(np.diff(np.signbit(r48))))
        check(sr == 16000 and abs(len(r48) - 16000) <= 2 and 0.3 < rms48 < 0.4 and 800 < zc < 960,
              f"native 48 kHz decode: {len(r48)} samples, rms {rms48}, {zc} zero crossings")
        wav_ms = {"native": time_host_ms(lambda: native.read_wav_native(p16)),
                  "python": time_host_ms(lambda: frontend.read_wav(p16))}

        golden = os.path.join(HERE, "tests", "golden", "mixed_filters.png")
        check(np.array_equal(pngio._read_png_native(golden, lib), pngio._read_png_python(golden)),
              "native PNG decode of the five-filter golden file differs from the Python one")
        png_ms = {}
        for name, ft in (("none", 0), ("sub", 1), ("up", 2), ("average", 3), ("paeth", 4)):
            p = _png_with_filter(os.path.join(tmp, f"{name}.png"), ft)
            check(np.array_equal(pngio._read_png_native(p, lib), pngio._read_png_python(p)),
                  f"native PNG decode under the {name} filter differs from the Python one")
            png_ms[name] = {"native": time_host_ms(lambda: pngio.read_png(p)),
                            "python": time_host_ms(lambda: pngio._read_png_python(p), reps=1)}
    emit({"phase": "host_codecs", "build": build, "wav_16k_max_abs_diff": wav_err,
          "frame_audio_equal": frames_equal,
          "wav_48k": {"samples": len(r48), "rms": rms48, "zero_crossings": zc},
          "wav_decode_ms_8s": wav_ms, "png_decode_ms_224_rgb": png_ms})


def time_host_ms(fn, reps: int = 5) -> float:
    """Median wall milliseconds of ``fn`` on the host over ``reps`` calls
    after one more."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def phase_diversity(pipe, cpu):
    """`diversity`: the mean pairwise distance of styles sampled for one
    instruction. ``diversity_score`` on the card against the CPU pipeline on
    the same weights with the same explicit prior draws (4 samples): within
    1e-3 relative; then the command at full width (4 samples, sample i
    seeded --seed + i on the card) against ``diversity_score`` on ``pipe``
    (the same seed-0 weights and seeds): the printed score equal."""
    import contextlib
    import io

    import numpy as np

    from avi_talking_tpu_torch.cli import main as cli_main
    from avi_talking_tpu_torch.cli.run import diversity_score

    text = "A fairly angry man speaks with brow fairly down"
    rng = np.random.default_rng(11)
    D, steps = pipe.cfg.clip_size, pipe.cfg.timesteps
    noise = [{"init": rng.standard_normal((1, 1, D)).astype(np.float32),
              "steps": rng.standard_normal((steps, 1, 1, D)).astype(np.float32)}
             for _ in range(4)]
    card = diversity_score(pipe, text, 4, 0, noise=noise)
    host = diversity_score(cpu, text, 4, 0, noise=noise)
    rel = abs(card - host) / abs(host)
    check(math.isfinite(card) and card > 0 and rel < 1e-3,
          f"diversity card {card} against CPU {host}: relative {rel}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["diversity", "--text", text, "--num-samples", "4"])
    cli_s = time.perf_counter() - t0
    line = buf.getvalue().strip().splitlines()[-1]
    direct = diversity_score(pipe, text, 4, 0)
    check(rc == 0 and line == f"diversity over 4 samples: {direct:.4f}",
          f"diversity printed {line!r}; diversity_score on the same weights gives {direct}")
    emit({"phase": "diversity", "card_vs_cpu": {"card": card, "cpu": host, "rel": rel,
                                                "tol": 1e-3},
          "cli": "diversity --text <text> --num-samples 4", "cli_line": line,
          "cli_wall_s": cli_s})


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
      T=25, conditioning on), 3 steps: K1 12 and K3 2 a step; the seconds
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
        out, _, wall = _run_cli(argv)
        return out, wall

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

    # train-faceformer --root: the command, its batches, conditioning and steps
    # probed; 3 steps (each reads 800 PNGs on the host, about 8 s, so more
    # steps add only host time)
    steps = 3
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


def _run_cli(argv):
    """``cli main(argv)`` with its output captured: (stdout, err, wall s);
    a non-zero exit fails the check."""
    import io

    import torch

    from avi_talking_tpu_torch.cli import main as cli_main

    buf, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    check(rc == 0, f"{argv[0]} exited {rc}: {err.getvalue()[-2000:]}")
    return buf.getvalue(), err.getvalue(), time.perf_counter() - t0


def _final_metrics(out: str) -> dict:
    """The ``final: {...}`` line of a training command, as floats."""
    import ast

    found = [ln for ln in out.splitlines() if ln.startswith("final:")]
    check(len(found) == 1, f"expected one final: line in {out[-2000:]!r}")
    return {k: float(v) for k, v in ast.literal_eval(found[0][len("final:"):].strip()).items()}


def _mead_data_root():
    """The train_data phase's 18-clip tree (224^2 crops), written here when
    that phase has not run."""
    root = os.path.join(HERE, "build", "chip_smoke", "mead_data")
    if not os.path.isdir(root):
        os.makedirs(root)
        _write_mead_tree(root, len(MEAD_DATA_CLIPS), 100, seed=21, names=MEAD_DATA_CLIPS,
                         crop_size=224)
    return root


def _portrait_source(size: int = 256):
    """A smooth synthetic size^2 RGB portrait: an ellipse 'face' with darker
    'eyes' and 'mouth' on a gradient."""
    import numpy as np

    yy, xx = np.mgrid[0:size, 0:size] / (size - 1.0)
    face = ((xx - 0.5) / 0.32) ** 2 + ((yy - 0.5) / 0.42) ** 2 < 1
    img = np.stack([0.3 + 0.4 * xx, 0.25 + 0.3 * yy, 0.5 - 0.2 * xx], axis=-1)
    img[face] = [0.85, 0.65, 0.55]
    for cx, cy, rx, ry in ((0.38, 0.4, 0.05, 0.025), (0.62, 0.4, 0.05, 0.025),
                           (0.5, 0.68, 0.1, 0.03)):
        img[((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 < 1] = [0.25, 0.12, 0.12]
    return (img * 255).astype(np.uint8)


def phase_portrait(pipe, kb):
    """The `portrait` path: `generate` on the 8 s clip (K1 12 launches),
    its coefficients through `cli portrait --coeffs` (PIRenderConfig() at
    256^2, --chunk 32, 200 frames, seeded random net_G), then on the
    renderer directly:

    - shapes, finiteness, repeatability (within 1e-4: cuDNN's transposed
      convolutions are not bit-stable), frames per second over
      three renders of the 200 frames, peak memory;
    - card vs CPU on 4 frames (fake and warp), within 1e-3 of the CPU
      output's largest;
    - chunked (8 a chunk) against one frame a chunk on 8 frames, within
      1e-4 of the largest (the convolutions' batch size may pick another
      cuDNN algorithm);
    - `--bf16` against fp32 on the same weights: rms(bf16 - fp32) below
      0.1 of fp32's rms, the two timed in turns;
    - `--net-g` on a synthetic reference-named net_G (``module.`` prefixed,
      under ``net_G_ema``): the command's unwrap loads weights bit-equal to
      `load_state_dict` of the stripped dict, their renders of 16 frames
      within 1e-4, and the command's frames within one level of that
      render's where it writes PNG frames;
    - `--control` (2 steps a leg: 18 legs, 36 frames).

    No kernel runs under PIRender (convolutions, as JAX's); the phase prints
    its seconds."""
    import shutil

    import numpy as np
    import torch

    from avi_talking_tpu_torch.cli.run import load_net_g
    from avi_talking_tpu_torch.models.pirender import FaceGenerator, PIRenderConfig
    from avi_talking_tpu_torch.pipeline.portrait import (PortraitRenderer, build_semantics,
                                                         frames_to_u8)
    from avi_talking_tpu_torch.viz.pngio import read_png, write_png

    t_phase = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "chip_smoke", "portrait")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    kb.launches = 0
    gen_out = pipe.generate(synthetic_wav(8.0, seed=1),
                            "A fairly angry man speaks with brow fairly down", seed=0)
    k1 = kb.launches
    check(k1 == 12, f"generate before portrait launched K1 {k1} times, not 12")
    coeffs = os.path.join(out_dir, "clip_coeffs.npz")
    np.savez(coeffs, exp=gen_out["exp"], jaw=gen_out["jaw"], style_emb=gen_out["style_emb"])
    src_u8 = _portrait_source()
    src_png = os.path.join(out_dir, "source.png")
    write_png(src_png, src_u8)

    out, err, cli_s = _run_cli(["portrait", "--source", src_png, "--coeffs", coeffs, "--out",
                                out_dir, "--chunk", "32"])
    check("portrait: 200 frames" in out and "RANDOM-init" in err, f"portrait printed {out!r}")
    written = out.strip().rsplit("-> ", 1)[1]
    if os.path.isdir(written):
        check(len(os.listdir(written)) == 200, f"{written} holds {len(os.listdir(written))} frames")

    cfg = PIRenderConfig()
    src = src_u8.astype(np.float32) / 127.5 - 1.0
    descr = build_semantics(gen_out["exp"], gen_out["jaw"])
    gen = FaceGenerator.random_init(cfg, seed=0, device="cuda")
    renderer = PortraitRenderer(gen, chunk=32)
    torch.cuda.reset_peak_memory_stats()
    res = renderer.render(src, descr, return_warp=True)
    check(res["fake"].shape == res["warp"].shape == (200, 256, 256, 3),
          f"portrait shapes {res['fake'].shape}")
    check(all(np.isfinite(v).all() for v in res.values()), "portrait: non-finite frames")
    check(float(np.abs(res["fake"]).max()) <= 1.0, "fake frames outside [-1, 1]")
    walls = {"float32": [], "bfloat16": []}
    repeat = 0.0
    gen16 = FaceGenerator.random_init(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    r16 = PortraitRenderer(gen16, chunk=32)
    b16 = r16.render(src, descr)  # warm-up
    for _ in range(3):
        for name, r in (("float32", renderer), ("bfloat16", r16)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = r.render(src, descr)
            walls[name].append(time.perf_counter() - t0)
            if name == "float32":
                repeat = max(repeat, float(np.abs(again["fake"] - res["fake"]).max()))
    # cuDNN's transposed convolutions (its backward-data algorithms) add
    # with atomics: a render is not bit-stable (2-2.5e-5 apart on an H100)
    check(repeat <= 1e-4, f"the same render differs by {repeat} (limit 1e-4)")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    rms = lambda a: float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))  # noqa: E731
    bf16_rel = rms(b16["fake"] - res["fake"]) / rms(res["fake"])
    check(bf16_rel < 0.1, f"portrait --bf16: rms to fp32 {bf16_rel} of fp32's (limit 0.1)")

    one = PortraitRenderer(gen, chunk=1).render(src, descr[:8])["fake"]
    eight = PortraitRenderer(gen, chunk=8).render(src, descr[:8])["fake"]
    chunk_rel = float(np.abs(one - eight).max() / np.abs(eight).max())
    check(chunk_rel < 1e-4, f"chunked vs per-frame: {chunk_rel} of the largest (limit 1e-4)")

    cpu_gen = FaceGenerator.random_init(cfg, seed=0, device="cpu")
    t0 = time.perf_counter()
    cpu4 = PortraitRenderer(cpu_gen, chunk=4).render(src, descr[:4], return_warp=True)
    cpu_s = time.perf_counter() - t0
    gpu4 = PortraitRenderer(gen, chunk=4).render(src, descr[:4], return_warp=True)
    card_cpu = {k: float(np.abs(gpu4[k] - cpu4[k]).max() / np.abs(cpu4[k]).max())
                for k in ("fake", "warp")}
    check(all(v < 1e-3 for v in card_cpu.values()),
          f"portrait card vs CPU: {card_cpu} of the largest (limit 1e-3)")
    del cpu_gen, gen16, r16

    # --net-g: a synthetic reference-named trainer checkpoint
    g = torch.Generator().manual_seed(7)
    ref_state = {k: v + 0.01 * torch.randn(v.shape, generator=g) for k, v in
                 FaceGenerator.random_init(cfg, seed=7, device="cpu").state_dict().items()}
    net_g = os.path.join(out_dir, "net_G.pth")
    torch.save({"net_G_ema": {f"module.{k}": v for k, v in ref_state.items()}, "net_G": {}},
               net_g)
    short = os.path.join(out_dir, "short_coeffs.npz")
    np.savez(short, exp=gen_out["exp"][:16], jaw=gen_out["jaw"][:16])
    via_cli = FaceGenerator(cfg).cuda().eval()
    via_cli.load_state_dict(load_net_g(net_g, cfg))
    direct = FaceGenerator(cfg).cuda().eval()
    direct.load_state_dict(ref_state)
    check(all(torch.equal(v, direct.state_dict()[k]) for k, v in via_cli.state_dict().items()),
          "--net-g's unwrap loaded other weights than load_state_dict")
    descr16 = build_semantics(gen_out["exp"][:16], gen_out["jaw"][:16])
    a = PortraitRenderer(via_cli, chunk=16).render(src, descr16)["fake"]
    b = PortraitRenderer(direct, chunk=16).render(src, descr16)["fake"]
    net_g_diff = float(np.abs(a - b).max())
    check(net_g_diff <= 1e-4, f"--net-g's render differs from load_state_dict's by {net_g_diff}")
    net_dir = os.path.join(out_dir, "net_g")
    out, err, net_s = _run_cli(["portrait", "--source", src_png, "--coeffs", short, "--net-g",
                                net_g, "--out", net_dir, "--chunk", "16"])
    check("RANDOM-init" not in err and "portrait: 16 frames" in out, f"--net-g printed {out!r}")
    written = out.strip().rsplit("-> ", 1)[1]
    cli_u8_diff = None
    if os.path.isdir(written):
        frames = sorted(os.listdir(written))
        check(len(frames) == 16, f"--net-g wrote {len(frames)} frames")
        cli_u8_diff = max(int(np.abs(read_png(os.path.join(written, f)).astype(int)
                                     - u.astype(int)).max())
                          for f, u in zip(frames, frames_to_u8(b)))
        check(cli_u8_diff <= 1, f"--net-g's frames differ from the render by {cli_u8_diff}")
    del via_cli, direct

    out, _, ctl_s = _run_cli(["portrait", "--source", src_png, "--control", "--control-steps",
                              "2", "--out", os.path.join(out_dir, "control")])
    check("control sweep: 18 legs, 36 frames" in out and "portrait: 36 frames" in out,
          f"--control printed {out!r}")
    del gen, renderer
    torch.cuda.empty_cache()
    f32 = statistics.median(walls["float32"])
    emit({"phase": "portrait", "config": "PIRenderConfig() (59-d, 256^2), seeded random net_G",
          "generate_k1_launches": k1, "cli": "portrait --coeffs <generate npz> --chunk 32",
          "cli_wall_s": cli_s, "frames": 200, "chunk": 32,
          "render_s_all": walls["float32"], "render_s_median": f32,
          "frames_per_s": 200 / f32,
          "bf16_render_s_all": walls["bfloat16"],
          "bf16_frames_per_s": 200 / statistics.median(walls["bfloat16"]),
          "bf16_rms_rel_to_fp32": bf16_rel, "bf16_limit": 0.1,
          "peak_allocated_gib": peak_gib, "repeat_max_abs_diff": repeat, "repeat_limit": 1e-4,
          "card_vs_cpu_4_frames": {"rel_to_largest": card_cpu, "limit": 1e-3,
                                   "cpu_s": cpu_s},
          "chunk8_vs_chunk1_rel": chunk_rel, "chunk_limit": 1e-4,
          "net_g": {"weights_bit_equal_to_load_state_dict": True,
                    "render_max_abs_diff": net_g_diff, "cli_frames_max_u8_diff": cli_u8_diff,
                    "cli_wall_s": net_s},
          "control": {"frames": 36, "cli_wall_s": ctl_s},
          "seconds": time.perf_counter() - t_phase})
    return {"k1_launches": k1, "frames_per_s": 200 / f32}


def _counting(counts: dict, key: str):
    """A wrapper that counts its function's calls in ``counts[key]``."""
    def wrap(orig):
        def counted(*args, **kwargs):
            counts[key] = counts.get(key, 0) + 1
            return orig(*args, **kwargs)
        return counted
    return wrap


def phase_train_faceformer_render(kb, kba):
    """`train-faceformer --root --render-loss --emo-loss` at its defaults
    (FaceFormerConfig(), B=16, T=25; FAN conditioning; two frames a step
    through PIRenderConfig() at the crops' 224^2, VGG19 at three scales
    and EmoNet, all frozen at seeded random init) on the train_data
    phase's tree, 4 steps: K1 12 forwards and 12 backwards, K3 2 and 2, a
    step; the render and emotion terms nonzero; step seconds (the
    command's own, probed) and peak memory. Then, cut to B=2 (T=25) for
    the CPU side, on one conditioned batch (conditioned on the card, as
    train_data's check): the render and emotion terms' gradient to the
    model nonzero, and one step card vs CPU by `one_step_card_vs_cpu`
    (1e-4, the 2 lr rule) with the same frames."""
    import types

    import torch

    from avi_talking_tpu_torch.cli import train as ff_cli
    from avi_talking_tpu_torch.models.faceformer import FaceFormerConfig
    from avi_talking_tpu_torch.train.faceformer_trainer import FaceFormerTrainer
    from avi_talking_tpu_torch.train.optim import adamw

    t_phase = time.perf_counter()
    root = _mead_data_root()
    steps = 4
    record = {"step_s": [], "launches": [], "losses": []}
    backward = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _patched(FaceFormerTrainer, "train_step", _step_probe(record, [kb, kba], {})), \
            _patched(kb, "attention_backward", _counting(backward, "keybias_attention")), \
            _patched(kba, "attention_backward", _counting(backward, "fused_bias_attention")):
        kb.launches = kba.launches = 0
        out, err, cli_s = _run_cli(["train-faceformer", "--root", root, "--render-loss",
                                    "--emo-loss", "--steps", str(steps)])
        launches = {"keybias_attention": kb.launches, "fused_bias_attention": kba.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(record["launches"] == [[12, 2]] * steps,
          f"the render-loss steps launched {record['launches']}, not K1 12 and K3 2 each")
    check(launches == {"keybias_attention": 12 * steps, "fused_bias_attention": 2 * steps},
          f"train-faceformer --render-loss --emo-loss launched {launches}")
    check(backward == {"keybias_attention": 12 * steps, "fused_bias_attention": 2 * steps},
          f"the steps ran {backward} attention backwards, not K1 12 and K3 2 each")
    final = _final_metrics(out)
    check(set(final) == {"coeff", "render", "emo", "loss"} and final["render"] > 0
          and final["emo"] > 0 and math.isfinite(final["loss"]), f"final {final}")
    check("EmoNet is RANDOM-init" in err and "RANDOM-init PIRender" in err, err[-2000:])

    cfg = FaceFormerConfig()
    small = types.SimpleNamespace(root=root, seq_length=25, batch_size=2, seed=3, tiny=False,
                                  fan_checkpoint=None, render_loss=True, emo_loss=True,
                                  emonet_checkpoint=None)
    cuda = torch.device("cuda")
    with contextlib.redirect_stderr(io.StringIO()):
        builder = ff_cli.mead_builder(small, cfg)
        source, cond = ff_cli.mead_source(small, cfg, cuda, builder)
        batch = {k: v.cpu() for k, v in
                 ff_cli.conditioned(next(source), cfg, cond, cuda, render=True).items()}
    frames = [3, 17]
    # the two terms' gradient to the model
    with contextlib.redirect_stderr(io.StringIO()):
        render = ff_cli.render_term(small, cfg, builder, cuda)
    render.frame_idx = frames
    model = _faceformer_model(cfg, seed=2, device=cuda)
    terms = render(model(batch["audio"].to(cuda), batch["coeff"].to(cuda),
                         batch["eye_embed"].to(cuda), batch["emo_embed"].to(cuda),
                         batch["ref_coeff"].to(cuda)),
                   {k: v.to(cuda) for k, v in batch.items()})
    grads = torch.autograd.grad(0.015 * terms["render"] + 0.15 * terms["emo"],
                                [p for p in model.parameters()], allow_unused=True)
    term_grad = max(float(g.abs().max()) for g in grads if g is not None)
    check(term_grad > 0, "the render and emotion terms give the model no gradient")
    del model, render, terms, grads
    pair, cpu_s = {}, None
    for dev in ("cuda", "cpu"):
        with contextlib.redirect_stderr(io.StringIO()):
            render = ff_cli.render_term(small, cfg, ff_cli.mead_builder(small, cfg),
                                        torch.device(dev))
        render.frame_idx = frames
        m = _faceformer_model(cfg, seed=2, device=dev)
        tr = FaceFormerTrainer(model=m, optimizer=adamw(m.parameters(), 1e-4),
                               render_loss_fn=render)
        t0 = time.perf_counter()
        metrics = tr.train_step({k: v.to(dev) for k, v in batch.items()})
        if dev == "cpu":
            cpu_s = time.perf_counter() - t0
        pair[dev] = (float(metrics["loss"]), dict(m.named_parameters()))
    one_step = one_step_card_vs_cpu(pair, lr=1e-4, loss_tol=1e-4 * max(1.0, abs(pair["cpu"][0])))
    del pair, render, tr, m
    torch.cuda.empty_cache()
    emit({"phase": "train_faceformer_render",
          "cli": f"train-faceformer --root <tree> --render-loss --emo-loss --steps {steps}",
          "batch": 16, "seq_length": 25, "crop": 224, "cli_wall_s": cli_s, "final": final,
          "launches": launches, "launches_per_step": record["launches"],
          "attention_backwards": backward, "losses": record["losses"],
          "step_s_all": record["step_s"],
          "step_s_median_after_first": statistics.median(record["step_s"][1:]),
          "peak_allocated_gib": peak_gib, "terms_grad_max_abs": term_grad,
          "gpu_vs_cpu_one_step_B2_T25": {**one_step, "frames": frames, "cpu_step_s": cpu_s,
                                         "cut": "B=2 (the command's B=16) for the CPU side"},
          "seconds": time.perf_counter() - t_phase})
    return {"launches": launches}


def _warp_step_card_vs_cpu(pair, lr: float) -> dict:
    """One PIRender optimizer step on the card against the same step on the
    CPU (``step_diffs``). Its gradient is ill-conditioned: the L1 terms'
    signs, VGG's relu masks and the bilinear warp's pixel edges flip under
    rounding, so on the CPU alone the float32 gradient of a full-width warp
    step lies 2.8e-3 (rms over the weights) from the float64 one, 6.4e-3 of
    the worst tensor's largest, and of a full step 6.9e-4 and 5.7e-2
    (``scripts/torch_pirender_grad_sensitivity.py``). So the loss is held
    to 1e-4 of itself, the gradient by its rms over all the weights within
    1e-2 of the CPU's, and every weight to 2 lr (Adam's first step moves
    each by lr times the sign of its gradient)."""
    d = step_diffs(pair)
    (_, t_g), (_, t_c) = pair["cuda"], pair["cpu"]
    num = den = 0.0
    for k, t in t_c.items():
        if t.grad is not None:
            num += float(((t_g[k].grad.cpu() - t.grad) ** 2).sum())
            den += float((t.grad ** 2).sum())
    rms_rel = math.sqrt(num / den)
    weights = max(d["param_max_abs_diff_where_grad_ge_floor"],
                  d["param_max_abs_diff_where_grad_lt_floor"])
    loss_tol = 1e-4 * max(1.0, abs(d["loss"]))
    check(d["loss_abs_diff"] < loss_tol and rms_rel < 1e-2 and weights <= 2 * lr + 1e-6,
          f"one PIRender step, card vs CPU: loss |d| {d['loss_abs_diff']} (tol {loss_tol}), "
          f"gradient rms {rms_rel} of the CPU's (limit 1e-2), weights max |d| {weights} "
          f"(limit 2 lr); worst tensor {d['grad_worst_tensor']} at {d['grad_max_rel_diff']}")
    return {**d, "grad_rms_rel": rms_rel, "grad_rms_limit": 1e-2, "weights_max_abs_diff": weights,
            "weights_limit": 2 * lr, "loss_tol": loss_tol}


def _pirender_trainer(device, seed=0, gan=False):
    """The trainer `train-pirender` builds at full width (PIRenderConfig(),
    VGG19 seed 1 with its five taps at three scales, with ``gan`` the
    two-scale discriminator seed 2), on ``device``."""
    import torch

    from avi_talking_tpu_torch.models.discriminator import MultiscaleDiscriminator
    from avi_talking_tpu_torch.models.pirender import FaceGenerator, PIRenderConfig
    from avi_talking_tpu_torch.train.perceptual import PerceptualLoss, Vgg19Features
    from avi_talking_tpu_torch.train.pirender_trainer import (PIRenderTrainer,
                                                              make_pirender_optimizer)

    gen = FaceGenerator.random_init(PIRenderConfig(), seed=seed, device=device).train()
    vgg = Vgg19Features.random_init(seed=1, device=device)
    disc = opt_d = None
    if gan:
        disc = MultiscaleDiscriminator.random_init(seed=2, device=device)
        opt_d = torch.optim.Adam(disc.parameters(), lr=1e-4, betas=(0.5, 0.999), eps=1e-8)
    opt, sched = make_pirender_optimizer(gen.parameters(), 1e-4)
    return PIRenderTrainer(generator=gen, optimizer=opt, scheduler=sched,
                           perceptual_warp=PerceptualLoss(vgg),
                           perceptual_final=PerceptualLoss(vgg, use_style_loss=True),
                           discriminator=disc, optimizer_d=opt_d)


def phase_train_pirender():
    """`train-pirender` at full width (PIRenderConfig(), 256^2, B=4, VGG19
    at five taps and three scales): synthetic pairs, 2 warp then 2 full
    steps with a checkpoint read back; synthetic `--gan`, 1 warp then 2
    GAN steps; `--root` on the train_data tree (224^2 crops resized to
    256^2) `--cross-id --gan`, 1 warp then 2 steps. Each stage's step
    seconds (the command's own, probed) and peak memory. Then, at B=1 for
    the CPU side, one step of each stage card vs CPU from the same seeded
    weights and batch (`_warp_step_card_vs_cpu`: the loss, the gradient's
    rms, every weight within 2 lr; the D step's too, taken from the initial
    generator on both sides: after G's step the two sides' fakes differ by
    G's 2 lr), and the editing net's
    first full-stage update on
    the card after 5 warp steps against Adam replayed on its gradient with
    optax's shared count (6), within 1e-3 of the update's largest."""
    import shutil

    import numpy as np
    import torch

    from avi_talking_tpu_torch.infra.checkpoint import restore_checkpoint
    from avi_talking_tpu_torch.models.discriminator import MultiscaleDiscriminator
    from avi_talking_tpu_torch.models.pirender import FaceGenerator, PIRenderConfig
    from avi_talking_tpu_torch.train.pirender_trainer import PIRenderTrainer

    t_phase = time.perf_counter()
    root = _mead_data_root()
    out_dir = os.path.join(HERE, "build", "chip_smoke", "pirender")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    runs = {}
    peak = 0.0
    for name, argv in (
            ("synthetic", ["--steps", "4", "--warp-steps", "2", "--ckpt-dir",
                           os.path.join(out_dir, "ck")]),
            ("synthetic_gan", ["--steps", "3", "--warp-steps", "1", "--gan"]),
            ("root_cross_id_gan", ["--root", root, "--steps", "3", "--warp-steps", "1",
                                   "--gan", "--cross-id"])):
        rec = {"step_s": [], "stage": [], "d_step_s": []}

        def probe(orig, rec=rec):
            def train_step(self, batch, warp_only, use_gan=False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = orig(self, batch, warp_only, use_gan)
                torch.cuda.synchronize()
                rec["step_s"].append(time.perf_counter() - t0)
                rec["stage"].append("warp" if warp_only else ("gan" if use_gan else "full"))
                return m
            return train_step

        def d_probe(orig, rec=rec):
            def d_train_step(self, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = orig(self, batch)
                torch.cuda.synchronize()
                rec["d_step_s"].append(time.perf_counter() - t0)
                return m
            return d_train_step

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with _patched(PIRenderTrainer, "train_step", probe), \
                _patched(PIRenderTrainer, "d_train_step", d_probe):
            out, err, wall = _run_cli(["train-pirender", "--log-every", "1", *argv])
        peak = max(peak, torch.cuda.max_memory_allocated() / 2 ** 30)
        final = _final_metrics(out)
        want = {"perceptual_warp", "perceptual_final", "loss"}
        if "--gan" in argv:
            want |= {"gan_g", "feature_matching", "gan_d"}
        check(set(final) == want and all(math.isfinite(v) for v in final.values()),
              f"train-pirender {name}: final {final}")
        runs[name] = {"cli_wall_s": wall, "final": final, "stages": rec["stage"],
                      "step_s_all": rec["step_s"], "d_step_s_all": rec["d_step_s"]}
        if "--root" in argv:
            check("video-pair data: 18 clips / 6 identities" in out, f"printed {out[:500]!r}")
    state = restore_checkpoint(os.path.join(out_dir, "ck"))["net_G"]
    FaceGenerator(PIRenderConfig()).load_state_dict(state)
    moved = max(float((state[k].cpu() - v).abs().max()) for k, v in FaceGenerator.random_init(
        PIRenderConfig(), seed=0, device="cpu").state_dict().items())
    check(0 < moved, "train-pirender's checkpoint did not move the generator")

    # one step of each stage, card vs CPU, from the same weights and batch (B=1)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(a.astype(np.float32)) for k, a in (
        ("input_image", rng.uniform(-1, 1, (1, 3, 256, 256))),
        ("target_image", rng.uniform(-1, 1, (1, 3, 256, 256))),
        ("coeff_window", rng.standard_normal((1, 59, 27))))}
    steps = {}
    cpu_s = {}
    for stage, warp_only, gan in (("warp", True, False), ("full", False, False),
                                  ("gan", False, True)):
        pair, d_pair = {}, {}
        for dev in ("cuda", "cpu"):
            tr = _pirender_trainer(torch.device(dev), gan=gan)
            b = {k: v.to(dev) for k, v in batch.items()}
            t0 = time.perf_counter()
            m = tr.train_step(b, warp_only, use_gan=gan)
            if dev == "cpu":
                cpu_s[stage] = time.perf_counter() - t0
            if gan:  # D's step from the same generator weights on both sides
                fresh = _pirender_trainer(torch.device(dev), gan=True)
                d_loss = float(fresh.d_train_step(b))
                d_pair[dev] = (d_loss, dict(fresh.discriminator.named_parameters()))
            named = dict(tr.generator.named_parameters())
            if warp_only:  # the editing net's gradient is zero here: not compared
                named = {k: v for k, v in named.items() if not k.startswith("editing_net.")}
            pair[dev] = (float(m["loss"]), named)
        steps[stage] = _warp_step_card_vs_cpu(pair, lr=1e-4)
        if gan:
            steps["gan_d"] = _warp_step_card_vs_cpu(d_pair, lr=1e-4)
        del pair, d_pair, tr
    torch.cuda.empty_cache()

    # the editing net's first full-stage update against optax's count rule
    tr = _pirender_trainer(torch.device("cuda"))
    b = {k: v.cuda() for k, v in batch.items()}
    for _ in range(5):
        tr.train_step(b, True)
    edit = {k: p for k, p in tr.generator.named_parameters() if k.startswith("editing_net.")}
    before = {k: p.detach().clone() for k, p in edit.items()}
    check(all(float(p.grad.abs().max()) == 0 for p in edit.values()),
          "the warp steps gave the editing net a gradient")
    tr.train_step(b, False)
    # after 5 zero-gradient steps the shared count is 6: optax moves a weight
    # 1.24 lr (m_hat 0.508 g over sqrt(v_hat) 0.409 |g|), a per-parameter
    # count restarted at 1 by lr
    t, lr, b1, b2, eps = 6, 1e-4, 0.5, 0.999, 1e-8
    worst, largest, restart = 0.0, 0.0, 0.0
    for k, p in edit.items():
        g = p.grad.double()
        m_hat = (1 - b1) * g / (1 - b1 ** t)
        v_hat = (1 - b2) * g * g / (1 - b2 ** t)
        want = -lr * m_hat / (v_hat.sqrt() + eps)
        got = (p.detach() - before[k]).double()
        worst = max(worst, float((got - want).abs().max()))
        largest = max(largest, float(want.abs().max()))
        restart = max(restart, float((-lr * g / (g.abs() + eps)).abs().max()))
    check(worst <= 1e-3 * largest, f"the editing net's first update is {worst} from optax's "
          f"count rule (largest {largest})")
    del tr
    torch.cuda.empty_cache()
    stage_s = {}
    for run in runs.values():
        for st, s in zip(run["stages"], run["step_s_all"]):
            stage_s.setdefault(st, []).append(s)
    emit({"phase": "train_pirender", "config": "PIRenderConfig(), 256^2, B=4, VGG19 5 taps x "
          "3 scales, discriminator 2 scales ndf 64", "runs": runs,
          "step_s_by_stage_all": stage_s, "peak_allocated_gib": peak,
          "checkpoint_moved_max_abs": moved,
          "gpu_vs_cpu_one_step_B1": {**steps, "cpu_step_s": cpu_s,
                                     "cut": "B=1 (the command's B=4) for the CPU side"},
          "editing_first_update": {"count": t, "max_abs_diff_to_optax_rule": worst,
                                   "largest_update": largest,
                                   "per_parameter_restart_would_be": restart},
          "seconds": time.perf_counter() - t_phase})
    return {"step_s_by_stage": {k: statistics.median(v) for k, v in stage_s.items()}}


def _write_face_root(root, n, size, seed, landmarks=True):
    """``n`` size^2 PNG frames (smooth colour ramps with noise) and, with
    ``landmarks``, a landmarks.npy of 68 points in [-0.8, 0.8] each."""
    import numpy as np

    from avi_talking_tpu_torch.viz.pngio import write_png

    os.makedirs(root, exist_ok=True)
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(n):
        c = r.uniform(0.2, 0.8, (3, 3)).astype(np.float32)
        img = (c[0] + c[1] * xx[..., None] * 0.5 + c[2] * yy[..., None] * 0.5) / 1.5
        img = img + r.normal(0, 0.03, img.shape).astype(np.float32)
        write_png(os.path.join(root, f"frame_{i:04d}.png"),
                  (np.clip(img, 0, 1) * 255).astype(np.uint8))
    if landmarks:
        np.save(os.path.join(root, "landmarks.npy"),
                r.uniform(-0.8, 0.8, (n, 68, 2)).astype(np.float32))
    return root


def _emoca_flame_npz(path):
    """The synthetic full-size FLAME (5023 / 9976, n_shape 100, n_exp 50, 68
    landmark tables) as the npz ``--flame-npz`` reads."""
    import numpy as np

    from avi_talking_tpu_torch.core.assets import synthetic_assets

    if not os.path.exists(path):
        a = synthetic_assets(num_vertices=5023, n_shape=100, n_exp=50, num_faces=9976,
                             n_static_landmarks=51)
        np.savez(path, **{f.name: getattr(a, f.name).numpy() for f in dataclasses.fields(a)})
    return path


def _kernel_route(device):
    """The renders' rasterization through the kernel route on ``device``:
    K2 on the card, its plain version on the CPU (whose own route is the
    plain binned one: with the synthetic FLAME's overflowing bins, another
    visibility)."""
    import functools
    from unittest import mock

    from avi_talking_tpu_torch.viz import shading
    from avi_talking_tpu_torch.viz.rasterizer import rasterize_auto

    if device.type == "cuda":
        return contextlib.nullcontext()
    return mock.patch.object(shading, "rasterize_auto",
                             functools.partial(rasterize_auto, backend="kernel"))


def _k2_row(case, ndc, faces, size, tile, kras, peaks, cap=1024):
    """K2 at a render's launch (``ndc`` (N, V, 3) on the card, ``cap``
    faces a tile): bit-equal to its plain version, its times, its bound and
    the bins' overflow."""
    import torch

    from avi_talking_tpu_torch.viz.rasterizer import _visibility_inputs, bin_overflow

    _, tri, valid, px, py, *_ = _visibility_inputs(ndc, faces, size, size, tile, cap)
    z, s = kras.rasterize_tiles_visibility(tri, valid, px, py)
    rz, rs = kras.rasterize_tiles_visibility_reference(tri, valid, px, py, chunk=64)
    err = float((z - rz).abs().max())
    check(torch.equal(s, rs) and torch.equal(z, rz),
          f"K2 at {case}: not bit-equal to the plain version ({int((s != rs).sum())} slots "
          f"differ, max |dz| {err})")
    del z, s, rz, rs
    most, share = bin_overflow(ndc, faces, size, size, tile, cap)

    def kernel():
        return kras.rasterize_tiles_visibility(tri, valid, px, py)

    row = {"case": case, "shape": list(tri.shape[:2]) + [px.shape[1]], "frames": int(ndc.shape[0]),
           "faces": int(faces.shape[0]), "valid_slots": int(valid.sum()),
           "live_slots_per_tile": live_slot_stats(valid),
           "bin_overflow": {"most_faces_in_a_tile": int(most), "tiles_over_cap": float(share),
                            "cap": cap, "overflow_load": bool(most > cap)},
           "max_abs_err": err, "ms": time_ms(kernel, iters=5, reps=5),
           "device_ms": device_ms(kernel, "rasterize_visibility", iters=5),
           "plain_ms": time_ms(lambda: kras.rasterize_tiles_visibility_reference(
               tri, valid, px, py, chunk=64), iters=1, reps=3),
           "library_ms": None}
    row.update(visibility_bound(tri, valid, px, py, peaks))
    emit({"phase": "kernel_check", "kernel": "rasterize_tiles_visibility", **row})
    return row


def _emoca_step_record(record, kras):
    """A wrapper of the EMOCA trainers' ``train_step`` that records each
    step's seconds (synchronised), terms and K2 launches."""
    import torch

    def wrap(orig):
        def train_step(self, optimizer, batch):
            torch.cuda.synchronize()
            before, t0 = kras.launches, time.perf_counter()
            out = orig(self, optimizer, batch)
            torch.cuda.synchronize()
            record.setdefault("step_s", []).append(time.perf_counter() - t0)
            record.setdefault("k2", []).append(kras.launches - before)
            return out
        return train_step
    return wrap


def _emoca_cli(argv, kras, trainer_cls):
    """One train-emoca run with its steps recorded: (record, final terms)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    record = {}
    kras.launches = 0
    with _patched(trainer_cls, "train_step", _emoca_step_record(record, kras)):
        out, _, wall = _run_cli(["train-emoca", *argv])
    record.update(argv=" ".join(argv), wall_s=wall, launches=kras.launches,
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  final=_final_metrics(out))
    check(all(math.isfinite(v) for v in record["final"].values()),
          f"train-emoca {record['argv']}: {record['final']}")
    return record


def _emoca_one_step(make, batch, lr):
    """One EMOCA / DECA step on the card and on the CPU (the renders through
    the kernel route on both) from the same seeded weights: the terms, the
    trained tensors (with their gradients) and the card's update against
    Adam replayed on the CPU with the card's gradients."""
    import functools

    import torch

    from avi_talking_tpu_torch.train.optim import adam

    out = {}
    for dev in (torch.device("cuda"), torch.device("cpu")):
        trainer, trained = make(dev)
        init = {k: t.detach().cpu().clone() for k, t in trained.items()}
        opt = trainer.make_optimizer(lr)
        with _kernel_route(dev):
            terms = trainer.train_step(opt, {k: v.to(dev) for k, v in batch.items()})
        out[dev.type] = {"terms": {k: float(v) for k, v in terms.items()}, "trained": trained,
                         "init": init, "trainer": trainer}
    card = out["cuda"]
    grads = {k: t.grad.cpu() for k, t in card["trained"].items() if t.grad is not None}
    replay = _replay(card["init"], grads, functools.partial(adam, lr=lr))
    update = max(float(((card["trained"][k].detach().cpu() - w).abs()
                        / (lr / 100 + 1e-6 * w.abs())).max()) for k, w in replay.items())
    terms_rel = {k: abs(v - out["cpu"]["terms"][k]) / max(abs(out["cpu"]["terms"][k]), 1e-8)
                 for k, v in card["terms"].items()}
    step = step_diffs({d: (o["terms"]["total"], o["trained"]) for d, o in out.items()},
                      rel_floor=1e-3)
    return out, {"terms": {d: o["terms"] for d, o in out.items()}, "terms_rel_diff": terms_rel,
                 "update_vs_adam_on_the_cards_gradients_over_limit": update,
                 "independent_step": step}


def phase_train_emoca(kras, peaks):
    """EMOCA / DECA training at full width (EmocaEncoder(): three ResNet-50
    towers, the synthetic full-size FLAME 5023 / 9976 with 68-point
    landmark tables, planar UVs, flat grey albedo) through `train-emoca` at
    its defaults (224^2, B=8, lr 1e-4; the detail stage's n_detail 128, UV
    256^2, generator init_size 8) on a `--root` folder of 24 PNG frames
    with landmarks.npy:

    a. the coarse stage, `--exp-only` (from its checkpoint: E_flame
       bit-unchanged), `--emo-loss` (a frozen seeded EmoNet) and `--detail`
       (the coarse checkpoint grafted: E_flame / E_expression bit-unchanged,
       E_detail and the generator moved, its running statistics with
       them): K2's launches per step (1: the textured / detail render),
       the steps' seconds and the peak memory of each run;
    b. one coarse step and one detail step at B=2 on the card and on the
       CPU (the renders through the kernel route on both) from the same
       weights and batch: the seeded encoder's codes within 1e-4 of their
       largest, the terms within 1e-3, the card's update within lr / 100 (+
       1e-6 |w|) of Adam replayed on the CPU with the card's gradients, the
       gradients within 1e-3 of the model's largest (the CPU tests' rule
       against JAX) and the weights by the 2·lr rule (1e-4 where |g| is at
       least 1e-3 of the largest);
    c. K2 at the B=8 render's launch (8 frames x 16 tiles of 56^2: the
       textured and the detail render rasterize the same coarse geometry)
       against its plain version, with the bins' overflow."""
    import numpy as np
    import torch

    from avi_talking_tpu_torch.cli.train_emoca import uv_assets
    from avi_talking_tpu_torch.core.assets import load_flame_assets
    from avi_talking_tpu_torch.core.flame import FlameModel
    from avi_talking_tpu_torch.infra.checkpoint import restore_checkpoint
    from avi_talking_tpu_torch.infra.init import random_module
    from avi_talking_tpu_torch.models.deca_detail import DecaDetailModel, DetailGenerator
    from avi_talking_tpu_torch.models.emoca import EmocaEncoder
    from avi_talking_tpu_torch.train import emoca_trainer as tet

    cuda = torch.device("cuda")
    out_dir = os.path.join(HERE, "build", "chip_smoke", "emoca")
    os.makedirs(out_dir, exist_ok=True)
    npz = _emoca_flame_npz(os.path.join(out_dir, "flame.npz"))
    root = _write_face_root(os.path.join(out_dir, "faces224"), 24, 224, seed=31)
    ck = {m: os.path.join(out_dir, "ck_" + m) for m in ("coarse", "exp", "detail")}
    base = ["--root", root, "--flame-npz", npz, "--log-every", "100"]

    # (a) the command in its four modes
    runs = {"coarse": _emoca_cli([*base, "--steps", "3", "--ckpt-dir", ck["coarse"]], kras,
                                 tet.EmocaTrainer)}
    runs["exp_only"] = _emoca_cli([*base, "--steps", "2", "--exp-only", "--checkpoint",
                                   ck["coarse"], "--ckpt-dir", ck["exp"]], kras, tet.EmocaTrainer)
    runs["emo_loss"] = _emoca_cli([*base, "--steps", "2", "--emo-loss"], kras, tet.EmocaTrainer)
    runs["detail"] = _emoca_cli([*base, "--steps", "3", "--detail", "--checkpoint", ck["coarse"],
                                 "--ckpt-dir", ck["detail"]], kras, tet.DecaDetailTrainer)
    for name, r in runs.items():
        check(r["k2"] == [1] * len(r["k2"]) and r["launches"] == len(r["k2"]),
              f"train-emoca {name}: K2 launched {r['k2']} a step ({r['launches']} in all), "
              "not once a step")
    check("emotion" in runs["emo_loss"]["final"] and runs["emo_loss"]["final"]["emotion"] > 0,
          f"--emo-loss: {runs['emo_loss']['final']}")
    coarse = restore_checkpoint(ck["coarse"])["encoder"]
    exp = restore_checkpoint(ck["exp"])["encoder"]
    detail = restore_checkpoint(ck["detail"])
    check(all(torch.equal(exp[k], v) for k, v in coarse.items() if k.startswith("E_flame.")),
          "--exp-only moved E_flame")
    check(not torch.equal(exp["E_expression.layers.2.weight"],
                          coarse["E_expression.layers.2.weight"]), "--exp-only left E_expression")
    check(all(torch.equal(detail["encoder"][k], v) for k, v in coarse.items()),
          "--detail moved the coarse towers")
    gen0 = DetailGenerator.random_init(3 + 50 + 128, init_size=8, seed=1, device="cpu").state_dict()
    moved = {k: not torch.equal(detail["generator"][k], v) for k, v in gen0.items()
             if not k.endswith("num_batches_tracked")}
    e_detail0 = random_module(lambda: EmocaEncoder(with_detail=True), torch.device("cpu"),
                              torch.Generator().manual_seed(0)).E_detail.layers[2].weight
    check(all(moved.values()) and not torch.equal(
        detail["encoder"]["E_detail.layers.2.weight"], e_detail0),
          f"--detail left {[k for k, m in moved.items() if not m]} or E_detail as they were")
    del coarse, exp, detail

    # (b) one coarse and one detail step, card vs CPU, at B=2
    Bc, lr = 2, 1e-4
    assets = load_flame_assets(npz, 100, 50)
    uv, uvf = uv_assets(None, assets)
    g = np.random.default_rng(5)
    batch = {"images": torch.from_numpy(g.uniform(0, 1, (Bc, 224, 224, 3)).astype(np.float32)),
             "lmk": torch.from_numpy(g.uniform(-0.8, 0.8, (Bc, 68, 2)).astype(np.float32))}

    def coarse_trainer(dev):
        enc = random_module(lambda: EmocaEncoder(), dev, torch.Generator().manual_seed(0))
        t = tet.EmocaTrainer(encoder=enc, flame=FlameModel(assets.to(dev)), uv_coords=uv.to(dev),
                             uv_faces=uvf.to(dev), image_size=224)
        return t, {k: p for k, p in enc.named_parameters()}

    def detail_trainer(dev):
        enc = random_module(lambda: EmocaEncoder(with_detail=True), dev,
                            torch.Generator().manual_seed(0))
        gen = DetailGenerator.random_init(181, init_size=8, seed=1, device=dev)
        flame = FlameModel(assets.to(dev))
        dm = DecaDetailModel(generator=gen, faces=flame.assets.faces, uv_coords=uv.to(dev),
                             uv_faces=uvf.to(dev), uv_size=256)
        t = tet.DecaDetailTrainer(encoder=enc, detail_model=dm, flame=flame, image_size=224)
        trained = {"E_detail." + k: p for k, p in enc.E_detail.named_parameters()}
        trained.update({"generator." + k: p for k, p in gen.named_parameters()})
        trained.update({"generator." + k: b for k, b in gen.named_buffers()
                        if k.endswith(("running_mean", "running_var"))})
        return t, trained

    with torch.no_grad():  # the seeded encoder's codes, before any step
        codes = {d.type: coarse_trainer(d)[0].encoder(batch["images"].to(d).permute(0, 3, 1, 2))
                 for d in (cuda, torch.device("cpu"))}
    codes_rel = max(float((codes["cuda"][k].cpu() - v).abs().max() / v.abs().max())
                    for k, v in codes["cpu"].items())
    check(codes_rel < 1e-4, f"the encoder's codes card vs CPU: {codes_rel}")
    del codes
    steps = {}
    for name, make in (("coarse", coarse_trainer), ("detail", detail_trainer)):
        t0 = time.perf_counter()
        sides, rep = _emoca_one_step(make, batch, lr)
        rep["seconds"] = time.perf_counter() - t0
        steps[name] = rep
        ind = rep["independent_step"]
        check(all(v < 1e-3 for v in rep["terms_rel_diff"].values()),
              f"{name} step card vs CPU: terms {rep['terms_rel_diff']}")
        check(rep["update_vs_adam_on_the_cards_gradients_over_limit"] <= 1.0,
              f"{name} step: the card's update lies "
              f"{rep['update_vs_adam_on_the_cards_gradients_over_limit']} x (lr / 100) from Adam "
              "on its own gradients")
        check(ind["grad_max_abs_diff_over_largest_grad"] < 1e-3
              and ind["param_max_abs_diff_where_grad_ge_floor"] < 1e-4
              and ind["param_max_abs_diff_where_grad_lt_floor"] <= 2 * lr + 1e-6,
              f"{name} step card vs CPU: gradients {ind['grad_max_abs_diff_over_largest_grad']} "
              f"of the largest, weights {ind['param_max_abs_diff_where_grad_ge_floor']} (|g| >= "
              f"floor) and {ind['param_max_abs_diff_where_grad_lt_floor']} (the others)")
        if name == "detail":
            enc0 = random_module(lambda: EmocaEncoder(with_detail=True), torch.device("cpu"),
                                 torch.Generator().manual_seed(0))
            enc = sides["cuda"]["trainer"].encoder
            frozen = all(torch.equal(t.cpu(), enc0.state_dict()[k])
                         for k, t in enc.state_dict().items() if not k.startswith("E_detail."))
            check(frozen, "the detail step moved the coarse towers")
        del sides

    # (c) K2 at the B=8 render's launch
    enc = random_module(lambda: EmocaEncoder(), cuda, torch.Generator().manual_seed(0))
    trainer = tet.EmocaTrainer(encoder=enc, flame=FlameModel(assets.to(cuda)),
                               uv_coords=uv.cuda(), uv_faces=uvf.cuda(), image_size=224)
    g8 = torch.from_numpy(np.random.default_rng(6).uniform(0, 1, (8, 224, 224, 3))
                          .astype(np.float32)).cuda()
    with torch.no_grad():
        ndc = trainer.decode(enc(g8.permute(0, 3, 1, 2)))["trans_verts"]
    row = _k2_row("emoca_224_tile56", ndc, trainer.flame.assets.faces, 224, 56, kras, peaks)
    del trainer, enc
    summary = {name: {"k2_launches_per_step": r["k2"], "step_s": r["step_s"],
                      "step_s_median_after_first": statistics.median(r["step_s"][1:]),
                      "peak_gib": r["peak_gib"], "wall_s": r["wall_s"], "argv": r["argv"],
                      "final": r["final"]} for name, r in runs.items()}
    emit({"phase": "train_emoca", "config": "EmocaEncoder() (3 ResNet-50 towers with the detail "
          "stage's E_detail), synthetic FLAME 5023 / 9976, planar UVs, grey albedo, 224^2, "
          "towers and generator at seeded random init", "batch": 8, "lr": lr, "runs": summary,
          "card_vs_cpu_B2": steps, "codes_rel_diff_card_vs_cpu": codes_rel,
          "k2_row": row["case"]})
    return {"runs": runs, "row": row}


def phase_reconstruct(kras, peaks):
    """`reconstruct --detail --textured` at full width on a folder of 16
    PNG frames at 256^2 (the synthetic full-size FLAME, planar UVs, grey
    albedo, seeded encoder and generator): the files written, K2's launches
    (2: the shaded and the textured render of all frames) and frames per
    second of the compute (a second call, warm); the first 2 frames on the
    card against the CPU (the renders through the kernel route on both):
    the codes within 1e-3 of their largest (the encoder's JAX tolerance),
    the vertices within 1e-4, and each render by the share of pixels that
    agree within 1e-3 (at least 0.999: a pixel whose winner changes with
    the codes' rounding differs); K2 at the renders' launch (16 frames x 64
    tiles of 32^2) against its plain version."""
    import argparse

    import numpy as np
    import torch

    from avi_talking_tpu_torch.cli.reconstruct import RECONSTRUCT_CAM, reconstruct_frames
    from avi_talking_tpu_torch.cli.train_emoca import uv_assets
    from avi_talking_tpu_torch.core.assets import load_flame_assets
    from avi_talking_tpu_torch.core.projection import batch_orth_proj
    from avi_talking_tpu_torch.models.deca_detail import world2uv

    out_dir = os.path.join(HERE, "build", "chip_smoke", "emoca")
    os.makedirs(out_dir, exist_ok=True)
    npz = _emoca_flame_npz(os.path.join(out_dir, "flame.npz"))
    frames = _write_face_root(os.path.join(out_dir, "faces256"), 16, 256, seed=41,
                              landmarks=False)
    res = os.path.join(out_dir, "reconstruct")
    kras.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out, _, wall = _run_cli(["reconstruct", "--image", frames, "--detail", "--textured",
                             "--flame-npz", npz, "--out-dir", res])
    cli_launches = kras.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    names = sorted(os.listdir(res))
    check(cli_launches == 2, f"reconstruct launched K2 {cli_launches} times, not 2")
    check(len(names) == 1 + 3 * 16 and "faces256_codes.npz" in names,
          f"reconstruct wrote {len(names)} files: {names[:6]}")

    args = argparse.Namespace(tiny=False, checkpoint=None, flame_npz=npz, size=256, detail=True,
                              detail_checkpoint=None, uv_obj=None, textured=True, tex_npz=None)
    from avi_talking_tpu_torch.viz.pngio import read_image_normalized

    paths = sorted(os.path.join(frames, p) for p in os.listdir(frames) if p.endswith(".png"))
    x = torch.from_numpy(np.stack([read_image_normalized(p) for p in paths]) * 0.5 + 0.5)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    reconstruct_frames(args, x.cuda(), cuda)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = reconstruct_frames(args, x.cuda(), cuda)
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with _kernel_route(cpu):
        ref = reconstruct_frames(args, x[:2], cpu)
    cpu_s = time.perf_counter() - t0
    codes_rel = max(float((card[0][k][:2].cpu() - v).abs().max() / v.abs().max())
                    for k, v in ref[0].items())
    verts_rel = float((card[1][:2].cpu() - ref[1]).abs().max() / ref[1].abs().max())
    close = {name: (card[i][:2].cpu() - ref[i]).abs().amax(-1) <= 1e-3
             for i, name in ((2, "shaded"), (3, "textured"), (4, "detail_normals"))}
    agree = {name: float(c.float().mean()) for name, c in close.items()}
    # the detail normals at the edge of the planar UVs' coverage come from
    # zero-area triangles, whose direction is rounding: held inside it
    assets = load_flame_assets(npz, 100, 50)
    faces = assets.faces.cuda()
    uv, uvf = uv_assets(None, assets)
    with torch.no_grad():
        empty = world2uv(card[1][:2], faces, uv.cuda(), uvf.cuda(), 256).abs().sum(-1) == 0
    inside = (torch.nn.functional.max_pool2d(empty.float()[:, None], 3, 1, 1)[:, 0] == 0).cpu()
    agree["detail_normals_inside_coverage"] = float(close.pop("detail_normals")[inside]
                                                    .float().mean())
    agree["uv_coverage_inside_share"] = float(inside.float().mean())
    check(codes_rel < 1e-3, f"reconstruct codes card vs CPU: {codes_rel}")
    check(verts_rel < 1e-4, f"reconstruct vertices card vs CPU: {verts_rel}")
    check(all(agree[k] >= 0.999 for k in ("shaded", "textured", "detail_normals_inside_coverage")),
          f"reconstruct renders card vs CPU: {agree}")
    check(all(bool(torch.isfinite(t).all()) for t in card[2:]), "non-finite reconstruct renders")

    proj = batch_orth_proj(card[1], torch.tensor([RECONSTRUCT_CAM], device=cuda))
    ndc = torch.stack([proj[..., 0], -proj[..., 1], -proj[..., 2]], dim=-1)
    row = _k2_row("reconstruct_256_tile32", ndc, faces, 256, 32, kras, peaks)
    emit({"phase": "reconstruct", "frames": 16, "size": 256, "cli_wall_s": wall,
          "cli_k2_launches": cli_launches, "peak_gib": peak, "compute_s": compute_s,
          "frames_per_s": 16 / compute_s, "cpu_s_2_frames": cpu_s,
          "card_vs_cpu_2_frames": {"codes_rel_diff": codes_rel, "vertices_rel_diff": verts_rel,
                                   "pixels_agreeing_within_1e-3": agree},
          "k2_row": row["case"]})
    return {"launches": cli_launches, "row": row}


def _face_video_frames(n, h, w, seed):
    """n (h, w, 3) uint8 frames: a face-like ellipse (skin, two eyes and a
    mouth) drifting over low-amplitude noise in 8 x 8 pixel blocks (which
    zlib compresses twenty times faster than per-pixel noise)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.ogrid[0:h, 0:w]
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        cx, cy = w * (0.5 + 0.02 * np.sin(0.3 * i)), h * (0.47 + 0.01 * np.cos(0.3 * i))
        noise = rng.integers(0, 6, (-(-h // 8), -(-w // 8), 3), dtype=np.uint8) * 6 + 60
        img = np.ascontiguousarray(noise.repeat(8, 0).repeat(8, 1)[:h, :w])
        rx, ry = 0.11 * w, 0.3 * h
        img[((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 < 1] = (215, 170, 145)
        for ex in (-0.4, 0.4):
            img[((xx - cx - ex * rx) / (0.18 * rx)) ** 2
                + ((yy - cy + 0.2 * ry) / (0.06 * ry)) ** 2 < 1] = (40, 30, 30)
        img[((xx - cx) / (0.45 * rx)) ** 2 + ((yy - cy - 0.45 * ry) / (0.07 * ry)) ** 2 < 1] = (
            150, 60, 60)
        out[i] = img
    return out


def _write_wav(path, seconds, seed):
    """A 16 kHz mono PCM16 wav of ``synthetic_wav``."""
    import wave

    import numpy as np

    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(synthetic_wav(seconds, seed), -1, 1) * 32767).astype("<i2")
                      .tobytes())
    return path


_STUB_FFMPEG = r"""
import json, struct, sys, wave

args = sys.argv[1:]
src = args[args.index("-i") + 1]
meta = json.load(open(src + ".meta.json"))
if "rawvideo" in args:
    import numpy
    sys.stdout.buffer.write(numpy.load(src + ".npy").tobytes())
elif "-vn" in args:
    w = wave.open(args[-1], "wb")
    w.setnchannels(1); w.setsampwidth(2); w.setframerate(16000)
    n = meta["nsamples"]
    w.writeframes(struct.pack("<%dh" % n, *([1000] * n))); w.close()
else:
    sys.stderr.write("Stream #0:0: Video: h264, yuv420p, %dx%d, 25 fps\n"
                     % (meta["width"], meta["height"]))
    sys.exit(1)
"""

_STUB_FFPROBE = r"""
import json, sys

meta = json.load(open(sys.argv[-1] + ".meta.json"))
print(json.dumps({"streams": [{"width": meta["width"], "height": meta["height"],
                               "avg_frame_rate": "25/1"}]}))
"""


def _stub_ffmpeg(bindir):
    """ffmpeg / ffprobe stand-ins on a PATH entry: a "video" is an .npy of
    packed yuv420p rows with a .meta.json beside it, streamed byte for byte
    (the rawvideo pipe, the probe and the audio demux as the real tools
    give them)."""
    import stat

    os.makedirs(bindir, exist_ok=True)
    for name, body in (("ffmpeg", _STUB_FFMPEG), ("ffprobe", _STUB_FFPROBE)):
        with open(os.path.join(bindir, f"_{name}.py"), "w") as f:
            f.write(body)
        sh = os.path.join(bindir, name)
        with open(sh, "w") as f:
            f.write(f"#!/bin/sh\nexec {sys.executable} {os.path.join(bindir, f'_{name}.py')} "
                    '"$@"\n')
        os.chmod(sh, os.stat(sh).st_mode | stat.S_IEXEC)
    return bindir


def _stage_timer(record, name, frames_arg):
    """A wrapper that adds each call's synchronised seconds and frames (the
    length of positional argument ``frames_arg``) to ``record[name]``."""
    import torch

    def wrap(orig):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            torch.cuda.synchronize()
            r = record.setdefault(name, {"s": 0.0, "frames": 0, "calls": 0})
            r["s"] += time.perf_counter() - t0
            r["frames"] += int(a[frames_arg].shape[0])
            r["calls"] += 1
            return out
        return timed
    return wrap


@contextlib.contextmanager
def _preprocess_stage_timers(record):
    """preprocess-mead's stages timed: S3FD's device top-1 boxes, FAN, the
    warps (the 256 box crops and the face crops), the EMOCA encoder and
    BiSeNet."""
    from avi_talking_tpu_torch.data import facecrop, preprocess
    from avi_talking_tpu_torch.models.bisenet import FaceParser
    from avi_talking_tpu_torch.models.fan_landmarks import FanLandmarkDetector
    from avi_talking_tpu_torch.models.sfd import SfdDetector

    with contextlib.ExitStack() as stack:
        for obj, attr, name, arg in ((SfdDetector, "best_box_device", "s3fd", 1),
                                     (FanLandmarkDetector, "__call__", "fan", 1),
                                     (facecrop, "warp_tensor", "warp", 0),
                                     (preprocess.EmocaPreprocessor, "_encode", "emoca", 1),
                                     (FaceParser, "__call__", "bisenet", 1)):
            stack.enter_context(_patched(obj, attr, _stage_timer(record, name, arg)))
        yield record


def _recorder(calls):
    """A wrapper that appends each call's (arguments, keywords, result) to
    ``calls``, its tensor arguments copied (a chunk's buffer may be
    filled again)."""
    import torch

    def wrap(orig):
        def recorded(*a, **kw):
            out = orig(*a, **kw)
            calls.append(([x.clone() if torch.is_tensor(x) else x for x in a], kw, out))
            return out
        return recorded
    return wrap


@contextlib.contextmanager
def _recorded(**targets):
    """``name=(obj, attr)`` -> ``{name: [(arguments, keywords, result), ...]}``
    of the calls made inside the block."""
    calls = {k: [] for k in targets}
    with contextlib.ExitStack() as stack:
        for k, (obj, attr) in targets.items():
            stack.enter_context(_patched(obj, attr, _recorder(calls[k])))
        yield calls


def _sfd_margins(maps, threshold):
    """S3FD's maps of a chunk -> (B,) the least gap on which its top-1
    decode decides a frame: the best anchor's score over the runner-up
    across the six scales, and its distance from ``threshold``."""
    import torch

    B = maps[0].shape[0]
    top = torch.cat([m[:, 1].reshape(B, -1) for m in maps[0::2]], 1).topk(2, dim=1).values
    return torch.minimum(top[:, 0] - top[:, 1], (top[:, 0] - threshold).abs())


def _heatmap_margins(hm):
    """(B, L, h, w) FAN heatmaps -> (B, L) the least gap on which each
    landmark's decode is decided: its peak over the runner-up and, at an
    interior peak, the neighbour differences whose signs give the
    quarter-pixel shift."""
    import torch

    B, L, h, w = hm.shape
    flat = hm.reshape(B, L, h * w)
    top = flat.topk(2, dim=2)
    px, py = top.indices[..., 0] % w, top.indices[..., 0] // w

    def at(dx, dy):
        i = (py + dy).clamp(0, h - 1) * w + (px + dx).clamp(0, w - 1)
        return flat.gather(2, i[..., None])[..., 0]

    gap = top.values[..., 0] - top.values[..., 1]
    nb = torch.minimum((at(1, 0) - at(-1, 0)).abs(), (at(0, 1) - at(0, -1)).abs())
    interior = (px > 0) & (px < w - 1) & (py > 0) & (py < h - 1)
    return torch.where(interior, torch.minimum(gap, nb), gap)


def _rel_max(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def phase_preprocess():
    """`preprocess-mead` as a user runs it, at full width on full frames:

    1. a tree of 2 clips x 32 frames at 1920x1080 (a face-like ellipse on
       noise, a 16 kHz wav a clip) and seeded reference-named checkpoints
       for 2DFAN4 (4 modules of depth 4, 256^2), S3FD and BiSeNet (512^2);
       `preprocess-mead --full-frames --fan-detect --parse-faces --fan-ckpt
       --sfd-ckpt --bisenet-ckpt` at its defaults (the EMOCA encoder at
       224^2, --max-b 32, --crop-scale 1.25, smoothing sigma 3): the files
       of each clip, finite codes, frames/s of each stage (S3FD, FAN, the
       warps, EMOCA, BiSeNet) and peak memory;
    2. the same with `--videos` on videos of 16 frames (the first clip's
       first 16, and those reversed: the host's yuv conversion runs once),
       through stub ffmpeg / ffprobe on a temporary PATH entry (a real
       ffmpeg found or not is printed first): the decoder's frames, the
       demuxed wav;
    3. the command on 1 frame on the card against `--device cpu`, each net
       and warp of the card's run recorded: S3FD's maps (both runs read the
       same frames), FAN's heatmaps on the card's stage-1 crops, BiSeNet's
       logits and the EMOCA codes on the card's crops, all run on the CPU
       within 1e-3 of their largest, and every warp of the card's run on the
       CPU from its frames, centres and sizes (float within 1e-3, uint8 a
       rounding step); the boxes and the decoded landmarks of the two runs
       equal but at a decision within twice the runs' largest map
       difference of a tie (the ties and the parted ones counted), FAN's
       scores and the full-frame landmarks within 1e-3, the parser's labels
       equal but at such ties and the masks parted on no more pixels than
       the labels; the files (landmarks, validity, codes within 1e-3, the
       crops a rounding step) held unless such a tie parted the runs;
    4. ``EmocaPreprocessor.encode_frames`` on the card under "u8" and "auto"
       against "float" within 2e-5 and under "yuv420" within 0.35, as the
       JAX suite holds them."""
    import argparse
    import glob
    import shutil
    import tempfile

    import numpy as np
    import torch

    from avi_talking_tpu_torch.cli.train_emoca import preprocess_nets
    from avi_talking_tpu_torch.data import facecrop
    from avi_talking_tpu_torch.data.preprocess import EmocaPreprocessor
    from avi_talking_tpu_torch.data.yuv import rgb_to_yuv420
    from avi_talking_tpu_torch.infra.init import random_module
    from avi_talking_tpu_torch.models.bisenet import BiSeNet, FaceParser
    from avi_talking_tpu_torch.models.fan_landmarks import FanLandmarkDetector, FanLandmarkNet
    from avi_talking_tpu_torch.models.sfd import S3FD, SfdDetector
    from avi_talking_tpu_torch.viz.pngio import read_png, write_png

    T, H, W = 32, 1080, 1920
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        t0 = time.perf_counter()
        frames = _face_video_frames(T, H, W, seed=51)
        src = os.path.join(tmp, "src")
        clips = {"M003_front_happy_level_1_001": frames, "W009_front_sad_level_2_002": frames[::-1]}
        for name, fr in clips.items():
            os.makedirs(os.path.join(src, name))
            for t, img in enumerate(fr):
                write_png(os.path.join(src, name, f"{t:05d}.png"), img)
            _write_wav(os.path.join(src, name, name + ".wav"), T / 25, seed=52)
        ck = {}
        for key, factory, seed in (("fan", FanLandmarkNet, 11), ("sfd", S3FD, 13),
                                   ("bisenet", BiSeNet, 12)):
            ck[key] = os.path.join(tmp, f"{key}.pth")
            torch.save(random_module(factory, torch.device("cpu"),
                                     torch.Generator().manual_seed(seed)).state_dict(), ck[key])
        setup_s = time.perf_counter() - t0
        flags = ["--full-frames", "--fan-detect", "--parse-faces", "--fan-ckpt", ck["fan"],
                 "--sfd-ckpt", ck["sfd"], "--bisenet-ckpt", ck["bisenet"]]

        # (1) the frame folders
        stages = {}
        torch.cuda.reset_peak_memory_stats()
        out = os.path.join(tmp, "out")
        with _preprocess_stage_timers(stages):
            stdout, err, wall = _run_cli(["preprocess-mead", "--src", src, "--out", out, *flags])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check("RANDOM-init" in err and "preprocessed 2/2 clips" in stdout,
              f"preprocess-mead: {stdout[-300:]} {err[-300:]}")
        for name in clips:
            d = os.path.join(out, name)
            codes = np.stack([np.concatenate([np.load(os.path.join(f, k + ".npy"))
                                              for k in ("exp", "pose", "shape", "cam")])
                              for f in sorted(glob.glob(d + "/EMOCA_v2_lr_mse_20/*_000"))])
            lmk = np.load(os.path.join(d, "landmarks.npy"))
            crop = read_png(os.path.join(d, "detections", "00000_000.png"))
            check(codes.shape == (T, 50 + 6 + 100 + 3) and bool(np.isfinite(codes).all())
                  and lmk.shape == (T, 68, 2) and bool(np.isfinite(lmk).all())
                  and crop.shape == (224, 224, 3)
                  and len(os.listdir(os.path.join(d, "masks"))) == T
                  and os.path.exists(os.path.join(d, name + ".wav"))
                  and np.load(os.path.join(d, "validity.npy")).shape == (T,),
                  f"preprocess-mead wrote {sorted(os.listdir(d))} for {name}")
        fps = {k: {**v, "frames_per_s": v["frames"] / v["s"]} for k, v in stages.items()}
        check(set(fps) == {"s3fd", "fan", "warp", "emoca", "bisenet"}, f"stages {sorted(fps)}")

        # (2) the same clips as videos, through the stub decoder
        real = shutil.which("ffmpeg")
        emit({"phase": "preprocess_ffmpeg", "real_ffmpeg_on_path": real,
              "decoder": "stub ffmpeg / ffprobe (an .npy of packed yuv420p rows a video)"})
        vids = os.path.join(tmp, "videos")
        os.makedirs(vids)
        TV = 16  # frames a video
        yuv = rgb_to_yuv420(frames[:TV])  # per frame: the reversed video's is its rows reversed
        for name, packed in zip(clips, (yuv, yuv[::-1])):
            path = os.path.join(vids, name + ".mp4")
            np.save(path + ".npy", packed)
            with open(path, "wb") as f:
                f.write(b"stub")
            with open(path + ".meta.json", "w") as f:
                json.dump({"width": W, "height": H, "nsamples": int(TV / 25 * 16000)}, f)
        saved_path = os.environ["PATH"]
        os.environ["PATH"] = _stub_ffmpeg(os.path.join(tmp, "bin")) + os.pathsep + saved_path
        try:
            vout = os.path.join(tmp, "vout")
            vstages = {}
            with _preprocess_stage_timers(vstages):
                _, _, vwall = _run_cli(["preprocess-mead", "--videos", "--src", vids,
                                              "--out", vout, *flags])
        finally:
            os.environ["PATH"] = saved_path
        for name in clips:
            d = os.path.join(vout, name)
            check(len(os.listdir(os.path.join(d, "EMOCA_v2_lr_mse_20"))) == TV
                  and np.load(os.path.join(d, "landmarks.npy")).shape == (TV, 68, 2)
                  and os.path.getsize(os.path.join(d, name + ".wav")) > 44,
                  f"preprocess-mead --videos wrote {sorted(os.listdir(d))} for {name}")

        # (3) 1 frame on the card against the CPU: each net and warp of the
        # card's run recorded, its inputs and its outputs (one frame: the
        # CPU's full-frame S3FD pass is most of the phase's CPU time)
        small = os.path.join(tmp, "small")
        name, n = next(iter(clips)), 1
        os.makedirs(os.path.join(small, name))
        for t in range(n):
            shutil.copyfile(os.path.join(src, name, f"{t:05d}.png"),
                            os.path.join(small, name, f"{t:05d}.png"))
        args = argparse.Namespace(tiny=False, checkpoint=None, max_b=n, fan_ckpt=ck["fan"],
                                  fan_detect=True, full_frames=True, bisenet_ckpt=ck["bisenet"],
                                  parse_faces=True, sfd_ckpt=ck["sfd"], sfd_threshold=0.5,
                                  flame_npz=None)
        targets = {"maps": (SfdDetector, "_maps"), "boxes": (SfdDetector, "best_box_device"),
                   "heatmaps": (FanLandmarkNet, "forward"),
                   "fan": (FanLandmarkDetector, "__call__"),
                   "full_lmk": (facecrop, "detect_fullframe_landmarks"),
                   "warps": (facecrop, "warp_tensor"), "logits": (BiSeNet, "forward"),
                   "labels": (FaceParser, "forward")}
        runs, rec = {}, {}
        for dev in ("cuda", "cpu"):
            runs[dev] = os.path.join(tmp, f"small_{dev}")
            t0 = time.perf_counter()
            with _recorded(**targets) as rec[dev]:
                _run_cli(["preprocess-mead", "--src", small, "--out", runs[dev], *flags,
                          "--max-b", str(n), *(["--device", "cpu"] if dev == "cpu" else [])])
            runs[dev + "_s"] = time.perf_counter() - t0
        c, p = ({k: v[0] if len(v) == 1 else v for k, v in rec[d].items()} for d in ("cuda", "cpu"))
        calls = {k: len(v) for k, v in rec["cuda"].items()}
        check(all(len(rec[d][k]) == 1 for d in rec for k in targets if k != "warps"),
              f"preprocess-mead on {n} frames: calls {calls}")
        cpu_nets = preprocess_nets(args, torch.device("cpu"))
        net = {}
        # S3FD's maps (both runs read the same full frames) and its top-1
        # boxes; a frame whose decision sits within twice the maps' largest
        # difference of a tie may part the runs
        card_maps = [m[:n].cpu() for m in c["maps"][2]]
        cpu_maps = [m[:n] for m in p["maps"][2]]
        net["s3fd_maps"] = max(_rel_max(a, b) for a, b in zip(card_maps, cpu_maps))
        d_s = max(float((a[:, 1] - b[:, 1]).abs().max())
                  for a, b in zip(card_maps[0::2], cpu_maps[0::2]))
        sfd_margin = _sfd_margins(card_maps, args.sfd_threshold)
        sfd_tie = (sfd_margin <= 2 * d_s).numpy()
        boxes = c["boxes"][2], p["boxes"][2]
        box_off = np.abs(boxes[0] - boxes[1]).max(-1) > 1e-3 * np.abs(boxes[1]).max()
        # FAN's heatmaps on the card's stage-1 crops, run on the CPU
        stage1 = c["heatmaps"][0][1]
        with torch.no_grad():
            net["fan_heatmaps"] = _rel_max(c["heatmaps"][2].cpu(), cpu_nets[1].model(stage1.cpu()))
        # the decoded landmarks of the two runs: equal but at the decisions
        # within twice the runs' largest heatmap difference of a tie
        hm = c["heatmaps"][2][:n].cpu(), p["heatmaps"][2][:n]
        keep = ~box_off
        rows = torch.from_numpy(keep)
        d_f = float((hm[0][rows] - hm[1][rows]).abs().max()) if keep.any() else 0.0
        fan_margin = _heatmap_margins(hm[0])
        fan_tie = (fan_margin <= 2 * d_f).numpy()
        lmk_off = (c["fan"][2][0] != p["fan"][2][0]).any(-1) & keep[:, None]
        parted = box_off | lmk_off.any(-1)
        full = c["full_lmk"][2], p["full_lmk"][2]
        det = {"s3fd_score_max_abs_diff": d_s, "s3fd_least_margin": float(sfd_margin.min()),
               "s3fd_frames_on_a_near_tie": int(sfd_tie.sum()),
               "box_frames_parted": int(box_off.sum()), "fan_heatmap_max_abs_diff": d_f,
               "fan_heatmap_largest": float(hm[1].abs().max()),
               "fan_least_margin": float(fan_margin.min()),
               "fan_landmarks_on_a_near_tie": int(fan_tie.sum()),
               "fan_landmarks_parted": int(lmk_off.sum()), "frames_parted": int(parted.sum()),
               "fan_scores": _rel_max(c["fan"][2][1][keep], p["fan"][2][1][keep]),
               "fullframe_landmarks": (_rel_max(full[0][0][~parted], full[1][0][~parted])
                                       if (~parted).any() else None)}
        check(not (box_off & ~sfd_tie).any() and not (lmk_off & ~fan_tie).any()
              and det["fan_scores"] < 1e-3 and (det["fullframe_landmarks"] or 0.0) < 1e-3,
              f"preprocess-mead detections on {n} frames, card vs CPU: {det}")
        # every warp of the card's run (the stage-1 crops and the face crops)
        # on the CPU from the same frames, centres and sizes
        warp = {"float_rel": 0.0, "u8_max_diff": 0, "u8_values_a_step_off": 0}
        for a, kw, got in rec["cuda"]["warps"]:
            want = facecrop.warp_tensor(*[x.cpu() if torch.is_tensor(x) else x for x in a], **kw)
            if got.dtype == torch.uint8:
                d = (got.cpu().int() - want.int()).abs()
                warp["u8_max_diff"] = max(warp["u8_max_diff"], int(d.max()))
                warp["u8_values_a_step_off"] += int((d > 0).sum())
            else:
                warp["float_rel"] = max(warp["float_rel"], _rel_max(got.cpu(), want))
        net["warps"] = warp
        check(len(rec["cuda"]["warps"]) == 2 and warp["float_rel"] < 1e-3
              and warp["u8_max_diff"] <= 1, f"preprocess-mead warps, card vs CPU: {warp}")
        card, cpu = (os.path.join(runs[d], name) for d in ("cuda", "cpu"))
        crops = {d: np.stack([read_png(os.path.join(q, "detections", f"{t:05d}_000.png"))
                              for t in range(n)]) for d, q in (("cuda", card), ("cpu", cpu))}
        masks = {d: np.stack([read_png(os.path.join(q, "masks", f"{t:05d}_000.png"))[..., 0]
                              for t in range(n)]) for d, q in (("cuda", card), ("cpu", cpu))}
        # the card's crops through the CPU's encoder and parser
        card_codes = {k: np.stack([np.load(os.path.join(card, "EMOCA_v2_lr_mse_20", f"{t:05d}_000",
                                                         k + ".npy")) for t in range(n)])
                      for k in ("exp", "pose", "shape", "cam")}
        want = cpu_nets[0].pseudo_gt(crops["cuda"], np.load(os.path.join(card, "validity.npy")))
        net["emoca_codes"] = max(_rel_max(card_codes[k], want[k]) for k in card_codes)
        with _recorded(logits=(BiSeNet, "forward"), labels=(FaceParser, "forward")) as same:
            _, cpu_mask = cpu_nets[2](crops["cuda"])
        logits = c["logits"][2].cpu(), same["logits"][0][2]
        net["bisenet_logits"] = _rel_max(*logits)
        d_b = float((logits[0] - logits[1]).abs().max())
        top = logits[0].topk(2, dim=1).values
        label_tie = (top[:, 0] - top[:, 1] <= 2 * d_b)[:n].numpy()
        label_off = (c["labels"][2].cpu() != same["labels"][0][2])[:n].numpy()
        # a label at 512^2 lands on one pixel of the mask at most
        mask_off = int((masks["cuda"] != (cpu_mask * 255).astype(np.uint8)).sum())
        parse = {"logits_max_abs_diff": d_b, "labels_on_a_near_tie": int(label_tie.sum()),
                 "labels_parted": int(label_off.sum()), "mask_pixels_parted": mask_off}
        check(max(net[k] for k in ("s3fd_maps", "fan_heatmaps", "emoca_codes", "bisenet_logits"))
              < 1e-3, f"preprocess-mead nets on the card's inputs, card vs CPU: {net}")
        check(not (label_off & ~label_tie).any() and mask_off <= label_off.sum(),
              f"preprocess-mead parser labels on the card's crops, card vs CPU: {parse}")
        # the files, held unless a tie parted the detections (the smoothed
        # box track then moves every crop of the clip)
        files = {rel: _rel_max(np.load(os.path.join(card, rel)), np.load(os.path.join(cpu, rel)))
                 for rel in ("landmarks.npy", "validity.npy")}
        files["codes"] = max(_rel_max(card_codes[k], np.stack([np.load(os.path.join(
            cpu, "EMOCA_v2_lr_mse_20", f"{t:05d}_000", k + ".npy")) for t in range(n)]))
                             for k in card_codes)
        crop_diff = np.abs(crops["cuda"].astype(int) - crops["cpu"])
        held = bool(max(files.values()) < 1e-3 and crop_diff.max() <= 1)
        cmp = {"nets_on_the_cards_inputs_rel": net, "detections": det, "parser": parse,
               "files_rel_diff": files, "crop_values_a_step_off": int((crop_diff > 0).sum()),
               "crop_max_diff": int(crop_diff.max()), "files_held": held,
               "files_left_out_for_a_parted_tie": not held and bool(parted.any()),
               "tree_masks_differing_pixels": int((masks["cuda"] != masks["cpu"]).sum()),
               "card_s": runs["cuda_s"], "cpu_s": runs["cpu_s"]}
        check(held or bool(parted.any()), f"preprocess-mead on {n} frames, card vs CPU: {cmp}")

        # (4) the transports of the encoder on the card
        pre = preprocess_nets(argparse.Namespace(**{**vars(args), "fan_ckpt": None,
                                                    "fan_detect": False, "full_frames": False,
                                                    "bisenet_ckpt": None, "parse_faces": False,
                                                    "sfd_ckpt": None}),
                              torch.device("cuda"))[0]
        u8 = np.stack([read_png(p) for p in sorted(glob.glob(
            os.path.join(out, name, "detections", "*.png")))[:16]])
        enc = {}
        for transport, x in (("float", u8.astype(np.float32) / 255.0), ("auto", u8),
                             ("u8", u8.astype(np.float32) / 255.0), ("yuv420", u8)):
            p = EmocaPreprocessor(encoder=pre.encoder, max_b=8, transport=transport)
            enc[transport] = p.encode_frames(x)
        transports = {t: max(float(np.abs(enc[t][k] - enc["float"][k]).max()) for k in enc[t])
                      for t in ("auto", "u8", "yuv420")}
        check(transports["auto"] < 2e-5 and transports["u8"] < 2e-5 and transports["yuv420"] < 0.35,
              f"encode_frames transports against float: {transports}")
    row = {"phase": "preprocess", "frames": T, "clips": len(clips), "size": [H, W],
           "flags": " ".join(f if not f.startswith(tmp) else "<tmp>" for f in flags),
           "setup_s": setup_s, "cli_wall_s": wall, "frames_per_s": 2 * T / wall,
           "stages": fps, "peak_gib": peak, "videos_cli_wall_s": vwall,
           "videos_stages": {k: {**v, "frames_per_s": v["frames"] / v["s"]}
                             for k, v in vstages.items()},
           "card_vs_cpu_1_frame": cmp, "transports_max_abs_diff_to_float": transports}
    emit(row)
    return row


def _bfm_assets(device):
    """Synthetic BFM09 assets at BFM's widths (id 80, exp 64, tex 80, 68
    keypoints) on a closed surface of BFM09 front's size: ``head_mesh(188,
    188)`` (70,688 faces against the real 70,789) in world units (radii 1.0 /
    1.25 / 0.8: at 224^2 and focal 1015 it fills the frame, its poles
    outside it), point_buf from the faces (padded with F)."""
    import numpy as np
    import torch

    from avi_talking_tpu_torch.viz.bfm import BfmAssets

    v, f = head_mesh(188, 188)
    w = np.stack([v[:, 0] / 0.58, v[:, 1] * 1.25 / 0.78, (v[:, 2] - 0.6) * 0.8 / 0.5], -1)
    V, F = len(w), len(f)
    vi = f.reshape(-1)
    order = np.argsort(vi, kind="stable")
    counts = np.bincount(vi, minlength=V)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    point_buf = np.full((V, counts.max()), F, np.int64)
    point_buf[vi[order], np.arange(len(vi)) - start[vi[order]]] = np.repeat(np.arange(F), 3)[order]
    rng = np.random.default_rng(61)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    return BfmAssets(meanshape=t(w.reshape(-1)), id_base=t(rng.normal(0, 2e-3, (3 * V, 80))),
                     exp_base=t(rng.normal(0, 2e-3, (3 * V, 64))),
                     meantex=t(rng.uniform(80, 200, 3 * V)),
                     tex_base=t(rng.normal(0, 1.0, (3 * V, 80))),
                     tri=torch.from_numpy(f.astype(np.int64)).to(device),
                     point_buf=torch.from_numpy(point_buf).to(device),
                     keypoints=torch.from_numpy(rng.choice(V, 68, replace=False)).to(device),
                     skinmask=t(rng.random(V) > 0.3))


def phase_bfm(kras, peaks):
    """The d3dfr BFM09 visualizer at BFM09 front's size: ``Visualizer3dmmBfm``
    at 224^2 (focal 1015) over 16 frames of seeded 257-d coefficients on
    ``_bfm_assets`` (70,688 faces): K2's launches (1 a render, at cap 4096,
    tile 32), the frames, frames/s (a second call, warm), peak memory; K2
    at this launch bit-equal to its plain version with its live slots per
    tile, its largest tile and the tiles over the cap (0 wanted), its times
    and bound; the render of 2 frames on the card against ``render_bfm`` on
    the CPU (its plain binned route): the masks equal and the colours within
    the JAX suite's 1e-3 + 1e-4 of the value (on a 0-255 scale) on at least
    0.999 of the pixels (a pixel whose winning face changes with rounding
    differs) and none by a colour step (1 of 255) or more; ``D3dfrReconNet`` at 224^2 (random
    heads: the zero init would compare nothing) card vs CPU within 1e-3 of
    its largest."""
    import numpy as np
    import torch

    from avi_talking_tpu_torch.infra.init import random_module
    from avi_talking_tpu_torch.viz.bfm import (D3dfrReconNet, Visualizer3dmmBfm, bfm_decode,
                                               project_vs, render_bfm)

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assets = _bfm_assets(cuda)
    rng = np.random.default_rng(62)
    c = rng.normal(0, 0.5, (16, 257)).astype(np.float32)
    c[:, 224:227] = rng.uniform(-0.1, 0.1, (16, 3))  # Euler angles
    c[:, 227:254] = rng.normal(0, 0.1, (16, 27))  # SH gamma
    c[:, 254:257] = rng.normal(0, 0.03, (16, 3))  # translation
    coeffs = torch.from_numpy(c).cuda()
    viz = Visualizer3dmmBfm(assets, img_size=224)
    torch.cuda.reset_peak_memory_stats()
    kras.launches = 0
    frames = viz(coeffs)
    torch.cuda.synchronize()
    launches = kras.launches
    check(launches == 1, f"Visualizer3dmmBfm launched K2 {launches} times, not 1")
    check(frames.shape == (16, 224, 224, 3) and bool(torch.isfinite(frames).all())
          and float(frames.amax()) <= 255.0, f"render_bfm frames {tuple(frames.shape)}")
    t0 = time.perf_counter()
    viz(coeffs)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    k2_render_ms = device_ms(lambda: viz(coeffs), "rasterize_visibility", iters=3)
    render_ms = time_ms(lambda: viz(coeffs), iters=3, reps=3)

    out = bfm_decode(assets, coeffs, viz.focal, 224)
    ndc = torch.cat([2.0 * project_vs(out["vs_t"], viz.focal, 224) / 224 - 1.0,
                     (10.0 - out["vs_t"][..., 2])[..., None]], -1)
    row = _k2_row("bfm_224_tile32_cap4096", ndc, assets.tri, 224, 32, kras, peaks, cap=4096)
    check(row["bin_overflow"]["tiles_over_cap"] == 0.0,
          f"render_bfm: {row['bin_overflow']} tiles over the cap of 4096")

    t0 = time.perf_counter()
    cpu_img, cpu_mask = render_bfm(assets.to(cpu), coeffs[:2].cpu(), 224, viz.focal)
    cpu_s = time.perf_counter() - t0
    card_img, card_mask = render_bfm(assets, coeffs[:2], 224, viz.focal)
    masks_equal = bool(torch.equal(card_mask.cpu(), cpu_mask))
    # the JAX suite's colour tolerance: 1e-3 + 1e-4 of the value (of 255)
    diff = (card_img.cpu() - cpu_img).abs()
    agree = float((diff <= 1e-3 + 1e-4 * cpu_img.abs()).all(-1).float().mean())
    colour_max_diff = float(diff.max())
    check(masks_equal and agree >= 0.999 and colour_max_diff < 1.0,
          f"render_bfm card vs CPU: masks equal {masks_equal}, pixels agreeing {agree}, "
          f"largest colour difference {colour_max_diff}")

    net = random_module(D3dfrReconNet, cpu, torch.Generator().manual_seed(63))
    g = torch.Generator().manual_seed(64)
    with torch.no_grad():
        for h in net.final_layers:
            h.weight.copy_(torch.randn(h.weight.shape, generator=g) * 0.02)
            h.bias.copy_(torch.randn(h.bias.shape, generator=g))
    x = torch.from_numpy(rng.uniform(0, 1, (4, 3, 224, 224)).astype(np.float32))
    with torch.no_grad():
        want = net(x)
        got = net.to(cuda)(x.cuda()).cpu()
    recon_rel = float((got - want).abs().max() / want.abs().max())
    check(recon_rel < 1e-3, f"D3dfrReconNet card vs CPU: {recon_rel}")
    emit({"phase": "bfm", "faces": int(assets.tri.shape[0]), "vertices": assets.num_vertices,
          "frames": 16, "size": 224, "cap": 4096, "k2_launches": launches,
          "render_s": render_s, "frames_per_s": 16 / render_s, "render_ms_events": render_ms,
          "k2_device_ms_per_render": k2_render_ms, "peak_gib": peak, "k2_row": row["case"],
          "live_slots_per_tile": row["live_slots_per_tile"], "bin_overflow": row["bin_overflow"],
          "card_vs_cpu_2_frames": {"masks_equal": masks_equal,
                                   "pixels_agreeing_within_1e-3_plus_1e-4_rel": agree,
                                   "colour_max_abs_diff": colour_max_diff, "cpu_s": cpu_s},
          "d3dfr_recon_224_card_vs_cpu_rel": recon_rel})
    return {"launches": launches, "row": row}


def phase_support_nets(kb):
    """PD-FGC's ``ResNetSE`` at its defaults (layers 3-4-6-3, filters 32 to
    256, 80 mels, SAP and ASP; 4 clips of 200 mel frames) and
    ``Wav2Vec2SER`` at wav2vec2-base on an 8 s clip, driven through
    ``SpeechEmotionRecognitionPreprocessor``: each card vs CPU within 1e-3
    of its largest (BatchNorm statistics and affine perturbed from the seed
    so that they are reached); K1's launches in the SER forward (12, one a
    layer)."""
    import numpy as np
    import torch

    from avi_talking_tpu_torch.audio.ser import Wav2Vec2SER
    from avi_talking_tpu_torch.audio.wav2vec2 import Wav2Vec2Config
    from avi_talking_tpu_torch.infra.init import random_module
    from avi_talking_tpu_torch.models.preprocessors import SpeechEmotionRecognitionPreprocessor
    from avi_talking_tpu_torch.models.resnet_se import ResNetSE

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    rng = np.random.default_rng(71)
    res = {}
    mel = torch.from_numpy(rng.standard_normal((4, 1, 80, 200)).astype(np.float32))
    for kind in ("SAP", "ASP"):
        net = random_module(lambda: ResNetSE(encoder_type=kind), cpu,
                            torch.Generator().manual_seed(72))
        g = torch.Generator().manual_seed(73)
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                    m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.1)
                    m.running_var.copy_(torch.rand(m.num_features, generator=g) * 0.5 + 0.75)
            want = net(mel)
            got = net.to(cuda)(mel.cuda()).cpu()
            t = time_ms(lambda: net(mel.cuda()), iters=5, reps=3)
        res[kind] = {"rel": float((got - want).abs().max() / want.abs().max()), "ms": t,
                     "shape": list(got.shape)}
        check(res[kind]["rel"] < 1e-3 and got.shape == (4, 512),
              f"ResNetSE {kind} card vs CPU: {res[kind]}")
    cfg = Wav2Vec2Config()
    ser = random_module(lambda: Wav2Vec2SER(cfg), cpu, torch.Generator().manual_seed(74))
    audio = torch.from_numpy(synthetic_wav(8.0, 75)[None])
    seen = {}
    with torch.no_grad():
        want = ser(audio)
        ser = ser.to(cuda)
        hook = ser.wav2vec2.encoder.layers[0].register_forward_pre_hook(
            lambda mod, a: seen.__setitem__("encoder_input", list(a[0].shape)))
        kb.launches = 0
        got = SpeechEmotionRecognitionPreprocessor(ser)(audio.cuda())["gt_audio_emotion_logits"]
        torch.cuda.synchronize()
        launches = kb.launches
        hook.remove()
        ser_ms = time_ms(lambda: ser(audio.cuda()), iters=3, reps=3)
    ser_rel = float((got.cpu() - want).abs().max() / want.abs().max())
    B, T = seen["encoder_input"][:2]
    heads = cfg.num_attention_heads
    k1_shape = [B, heads, T, T, cfg.hidden_size // heads]
    check(launches == 12, f"Wav2Vec2SER launched K1 {launches} times, not 12")
    check(ser_rel < 1e-3 and got.shape == (1, 8), f"Wav2Vec2SER card vs CPU: {ser_rel}")
    emit({"phase": "support_nets", "resnet_se": res,
          "wav2vec2_ser": {"seconds_of_audio": 8.0, "k1_launches": launches, "rel": ser_rel,
                           "ms": ser_ms, "encoder_input": seen["encoder_input"],
                           "k1_shape": k1_shape}})
    return {"k1_launches": launches, "k1_shape": k1_shape}


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
    return cpu


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


# K1 bf16's shapes on the generate path: name, B, H, T, S, d, valid keys per batch
BF16_CASES = [
    ("generate", 1, 12, 200, 200, 64, (200,)),
    ("batch_512", 2, 12, 512, 512, 64, (512, 300)),
    ("ragged_333", 1, 12, 333, 333, 64, (333,)),
    ("generate_600", 1, 12, 600, 600, 64, (600,)),
]
# K and V past the 227 KB a block may take: the kernel streams them
BF16_STREAMED = [("streamed_d128", 1, 2, 64, 600, 128, (600,))]
# train-emote --bf16's step: B=8, 64 frames after the 50 -> 25 fps resample
BF16_TRAIN = [("emote_train", 8, 12, 64, 64, 64, (64,) * 8)]


def bf16_inputs(B, H, T, S, d, lens, g):
    """bfloat16 q (scaled by d^-1/2), k, v and a (B, S) key bias of 0 for
    the first lens[b] keys of batch b and -1e9 past them, on the card."""
    import torch

    q = (torch.randn(B, H, T, d, device="cuda", generator=g) * d ** -0.5).bfloat16()
    k = torch.randn(B, H, S, d, device="cuda", generator=g).bfloat16()
    v = torch.randn(B, H, S, d, device="cuda", generator=g).bfloat16()
    valid = torch.tensor(lens, device="cuda")
    bias = torch.where(torch.arange(S, device="cuda")[None] < valid[:, None], 0.0,
                       -1e9).bfloat16()
    return q, k, v, bias


def phase_kernels_bf16(peaks, cases=None):
    """K1's bfloat16 entry against its plain version on the card at the
    generate path's shapes (bfloat16 q, k, v and key bias, as wav2vec2 sends
    them under --bf16), at BF16_STREAMED's, where K and V stream through
    shared memory, and at `train-emote --bf16`'s step (BF16_TRAIN), each row
    marked with its ``path`` (the kernels line's headline shape stays
    generate's); ``cases`` picks some of them. Limit (``kb.bf16_disagreement``, which derives it):
    each element within 2^-7 |ref| + 2^-9 max|ref| (one bfloat16 step of the
    output, since both sides round P and the output from float32 values that
    differ only in summation order and the exponential's last bits, plus a
    share for flipped P), and rms(out - ref) within 2^-11 rms(ref) plus one
    element's step over the N elements (few elements flip; a kernel that
    mis-normalises P by 0.4% or rounds the unnormalised exponentials reads
    2^-7.6 or 2^-8.4 rms(ref)). With its time (CUDA events around the
    wrapper, the kernel's device time under torch.profiler), the plain
    version's, scaled_dot_product_attention's at bfloat16 with the same
    float mask, and the bound at the bf16 peak."""
    import torch
    import torch.nn.functional as F

    from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb

    g = torch.Generator(device="cuda").manual_seed(1)
    paths = {c: "generate --bf16" for c in BF16_CASES}
    paths.update({c: "streamed: K and V past the shared-memory fit, on no path of the product"
                  for c in BF16_STREAMED})
    paths.update({c: "train-emote --bf16 (forward, 12 a step)" for c in BF16_TRAIN})
    rows = []
    for case in cases or BF16_CASES + BF16_STREAMED + BF16_TRAIN:
        name, B, H, T, S, d, lens = case
        q, k, v, bias = bf16_inputs(B, H, T, S, d, lens, g)
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
            "path": paths[case],
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


def _synced_stamps(stamps: list):
    """A wrapper of a batch generator function whose batches are handed out
    after a synchronise, each stamped: step i of the loop that takes them
    lasts from stamp i to stamp i + 1."""
    import torch

    def wrap(orig):
        def batches(*args, **kwargs):
            for b in orig(*args, **kwargs):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                yield b
        return batches
    return wrap


def _flint_step_s(stamps: list, warmup: int = 2) -> dict:
    steps = [b - a for a, b in zip(stamps, stamps[1:])][warmup:]
    return {"step_s_median": statistics.median(steps), "step_s_all": steps}


def phase_train_flint():
    """`train-flint` at its defaults (FlintConfig(), B=32, T=64): the VAE
    for 50 steps (the flint/ scalars at step 50), --vq for 20, and --root
    on the 18-clip MEAD tree for 6; step seconds (median after two, each
    ending in a synchronise), peak memory. One step of each mode card vs
    CPU from the same weights, batch and noise (``one_step_card_vs_cpu``:
    the loss within 1e-4, the weights by the 2 lr rule; the BatchNorms'
    running statistics, updated by the step, within 1e-5), and the card's
    checkpoint loaded back bit-equal. No kernel of the port runs here:
    FLINT's encoder layers keep the plain attention, as JAX's do."""
    import copy

    import numpy as np
    import torch

    from avi_talking_tpu_torch.cli import train_emote as cli_train_emote
    from avi_talking_tpu_torch.infra.checkpoint import restore_checkpoint
    from avi_talking_tpu_torch.infra.init import random_module
    from avi_talking_tpu_torch.models.flint import FlintConfig
    from avi_talking_tpu_torch.models.flint_vae import FlintVAE, FlintVQVAE
    from avi_talking_tpu_torch.train.driver import train_flint_vae

    out_dir = os.path.join(HERE, "build", "chip_smoke", "flint")
    runs = {}
    # --root's step is the host's batch (7,200 npy loads for B=18, ROADMAP S2b): 6 steps
    for name, extra, steps in (("vae", [], 50), ("vq", ["--vq"], 20),
                               ("root", ["--root", _mead_data_root()], 6)):
        stamps = []
        logdir = os.path.join(out_dir, name, "logs")
        torch.cuda.reset_peak_memory_stats()
        with _patched(cli_train_emote, "flint_batches", _synced_stamps(stamps)):
            out, _, wall = _run_cli(["train-flint", "--steps", str(steps), "--ckpt-dir",
                                     os.path.join(out_dir, name, "ck"), "--logdir", logdir]
                                    + extra)
        final = _final_metrics(out)
        check(all(math.isfinite(v) for v in final.values()), f"train-flint {name}: {final}")
        check(len(stamps) == steps, f"train-flint {name} took {len(stamps)} batches")
        runs[name] = {"final": final, "wall_s": wall, **_flint_step_s(stamps),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    with open(os.path.join(out_dir, "vae", "logs", "scalars.jsonl")) as f:
        logged = sorted(k for line in f for k in json.loads(line) if k.startswith("flint/"))
    check(logged == ["flint/kl", "flint/loss", "flint/recon"],
          f"train-flint logged {logged} at step 50")

    cfg, lr = FlintConfig(), 1e-4
    rng = np.random.default_rng(31)
    motion = (rng.standard_normal((32, 64, cfg.out_dim)) * 0.1).astype(np.float32)
    noise = torch.from_numpy(rng.standard_normal((32, 8, cfg.feature_dim)).astype(np.float32))
    held = {}
    for quantizer, factory in ((None, lambda: FlintVAE(cfg)), ("vq", lambda: FlintVQVAE(cfg))):
        base = random_module(factory, torch.device("cpu"), torch.Generator().manual_seed(32))
        pair, stats, res = {}, {}, {}
        ck = os.path.join(out_dir, f"card_vs_cpu_{quantizer or 'vae'}")
        for dev in ("cuda", "cpu"):
            m = copy.deepcopy(base).to(dev)
            res[dev] = train_flint_vae(iter([motion]), 1, cfg, lr=lr, quantizer=quantizer,
                                       device=dev, vae=m, noise=lambda i, s, d=dev: noise.to(d),
                                       ckpt_dir=ck if dev == "cuda" else None)
            pair[dev] = (res[dev]["metrics"]["loss"], dict(m.named_parameters()))
            stats[dev] = {k: v.cpu() for k, v in res[dev]["batch_stats"].items()}
        d = one_step_card_vs_cpu(pair, lr, loss_tol=1e-4)
        start = dict(base.named_buffers())
        stats_err = max(float((stats["cuda"][k] - v).abs().max()) for k, v in stats["cpu"].items())
        stats_moved = min(float((v - start[k]).abs().max()) for k, v in stats["cpu"].items())
        check(stats_err < 1e-5 and stats_moved > 0,
              f"flint {quantizer or 'vae'}: running statistics card vs CPU {stats_err}, "
              f"moved {stats_moved}")
        saved = restore_checkpoint(ck)
        fresh = random_module(factory, torch.device("cuda"), torch.Generator().manual_seed(0))
        missing, unexpected = fresh.load_state_dict({**saved["params"], **saved["batch_stats"]},
                                                    strict=False)
        check(not unexpected and all(k.endswith("num_batches_tracked") for k in missing),
              f"flint checkpoint keys: missing {missing}, unexpected {unexpected}")
        for k, v in res["cuda"]["vae"].state_dict().items():
            check(torch.equal(fresh.state_dict()[k], v), f"flint checkpoint round trip: {k}")
        held[quantizer or "vae"] = {**d, "stats_max_abs_diff": stats_err,
                                    "stats_min_moved": stats_moved}
    emit({"phase": "train_flint", "config": "FlintConfig() B=32 T=64", "runs": runs,
          "card_vs_cpu": held, "checkpoint_round_trip": "bit-equal"})
    return runs


def _w2v_forward(model, kb, audio, **kw):
    """One forward on the card with K1's count zeroed before it and read
    after it, and the first encoder layer's input shape."""
    import torch

    seen = {}
    hook = model.encoder.layers[0].register_forward_pre_hook(
        lambda mod, a: seen.__setitem__("shape", list(a[0].shape)))
    try:
        kb.launches = 0
        out = model(audio, **kw)
        torch.cuda.synchronize()
        launches = kb.launches
    finally:
        hook.remove()
    return out, launches, seen["shape"]


def phase_specaugment(kb):
    """wav2vec2-base at full width built with ``mask_time=True`` (seeded,
    ``masked_spec_embed`` from U[0, 1)): an 8 s clip with a
    ``compute_mask_indices`` mask (p 0.5, length 2, as the JAX test draws)
    over its 199 frames at 25 fps, B=8 over 64 frames with a mask each, and
    ``resample=False`` on the 8 s clip (399 frames at 50 fps). Each forward:
    K1 12 launches, the shape K1 saw, card vs CPU within 1e-3 of the CPU's
    largest value, and its milliseconds; the masked forwards against the
    unmasked on the card (the mask moves the output)."""
    import numpy as np
    import torch

    from avi_talking_tpu_torch.audio.specaugment import compute_mask_indices
    from avi_talking_tpu_torch.audio.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
    from avi_talking_tpu_torch.infra.init import random_module

    cfg = Wav2Vec2Config()
    cpu_model = random_module(lambda: Wav2Vec2Model(cfg, mask_time=True), torch.device("cpu"),
                              torch.Generator().manual_seed(41))
    model = random_module(lambda: Wav2Vec2Model(cfg, mask_time=True), torch.device("cuda"),
                          torch.Generator().manual_seed(41))
    wav = torch.from_numpy(synthetic_wav(8.0, 42)[None])
    batch = torch.from_numpy(np.stack([synthetic_wav(64 / 25, 43 + b) for b in range(8)]))
    cases = {
        "masked_8s": (wav, dict(mask_time_indices=torch.from_numpy(
            compute_mask_indices((1, 199), 0.5, 2, rng=np.random.default_rng(3))))),
        "masked_b8_t64": (batch, dict(output_len=64, mask_time_indices=torch.from_numpy(
            compute_mask_indices((8, 64), 0.5, 2, rng=np.random.default_rng(4))))),
        "native_8s": (wav, dict(resample=False)),
    }
    res = {}
    with torch.no_grad():
        for name, (audio, kw) in cases.items():
            want = cpu_model(audio, **kw)
            dev_kw = {k: v.cuda() if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
            got, launches, shape = _w2v_forward(model, kb, audio.cuda(), **dev_kw)
            rel = float((got.cpu() - want).abs().max() / want.abs().max())
            row = {"launches": launches, "encoder_input": shape, "rel": rel,
                   "k1_shape": [shape[0], cfg.num_attention_heads, shape[1], shape[1],
                                cfg.hidden_size // cfg.num_attention_heads],
                   "ms": time_ms(lambda: model(audio.cuda(), **dev_kw), iters=3, reps=3)}
            check(launches == 12, f"wav2vec2 {name} launched K1 {launches} times, not 12")
            check(rel < 1e-3 and bool(torch.isfinite(got).all()),
                  f"wav2vec2 {name} card vs CPU: {rel}")
            if "mask_time_indices" in kw:
                plain = model(audio.cuda(), **{k: v for k, v in dev_kw.items()
                                               if k != "mask_time_indices"})
                row["masked_frames"] = int(kw["mask_time_indices"].sum())
                row["mask_moves_output"] = float((got - plain).abs().max())
                check(row["mask_moves_output"] > 1e-3, f"wav2vec2 {name}: the mask moved nothing")
            res[name] = row
    check(res["native_8s"]["encoder_input"][1] == 399 and res["masked_8s"]["encoder_input"][1] == 199,
          f"wav2vec2 frame counts {res}")
    emit({"phase": "specaugment", "seconds_of_audio": 8.0, **res})
    return res


def phase_ablation():
    """EMOTE's ablation decoders at EMOTE's widths (feature 128, 15069
    vertex offsets; ``flame_bert`` decoding the synthetic full-size FLAME)
    and the four sequence encoders at 128 over wav2vec2-base's 768 features,
    on B=8, T=64, card vs CPU within 1e-3 of the CPU's largest value; the
    zero-initialised heads redrawn so that they reach the output."""
    import numpy as np
    import torch

    from avi_talking_tpu_torch.core.assets import synthetic_assets
    from avi_talking_tpu_torch.infra.init import random_module
    from avi_talking_tpu_torch.models.decoders import DecoderConfig, FeedForwardDecoder
    from avi_talking_tpu_torch.models.sequence_encoders import sequence_encoder_from_name

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    rng = np.random.default_rng(51)
    hidden = torch.from_numpy(rng.standard_normal((8, 64, 128)).astype(np.float32))
    style = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32))
    feats = torch.from_numpy(rng.standard_normal((8, 64, 768)).astype(np.float32))
    assets = synthetic_assets(num_vertices=5023, n_shape=300, n_exp=50, num_faces=9976)
    res = {}

    def held(name, make, *inputs, flame=None):
        m = random_module(make, cpu, torch.Generator().manual_seed(52))
        if hasattr(m, "decoder"):
            with torch.no_grad():
                m.decoder.weight.normal_(0.0, 128 ** -0.5,
                                         generator=torch.Generator().manual_seed(53))
        with torch.no_grad():
            want = m(*inputs)
            m = m.to(cuda)
            if flame is not None:  # the assets are the caller's to place, as the EMOTE head's
                m.flame_assets = flame.to(cuda)
            got = m(*(x.to(cuda) for x in inputs))
            torch.cuda.synchronize()
            ms = time_ms(lambda: m(*(x.to(cuda) for x in inputs)), iters=3, reps=3)
        if not isinstance(want, dict):
            want, got = {"out": want}, {"out": got}
        rel = {k: float((got[k].cpu() - w).abs().max() / w.abs().max()) for k, w in want.items()}
        res[name] = {"rel": rel, "ms": ms, "shapes": {k: list(v.shape) for k, v in got.items()}}
        check(all(r < 1e-3 for r in rel.values()), f"{name} card vs CPU: {rel}")

    for kind in ("linear", "mlp", "bert", "flame_bert"):
        dcfg = DecoderConfig(kind=kind, feature_dim=128, vertices_dim=15069, nhead=8)
        fa = assets if kind == "flame_bert" else None
        held(f"decoder_{kind}", lambda: FeedForwardDecoder(dcfg, flame_assets=fa), hidden, style,
             flame=fa)
    check(res["decoder_flame_bert"]["shapes"]["vertices"] == [8, 64, 5023, 3],
          f"flame_bert vertices {res['decoder_flame_bert']['shapes']}")
    for name in ("linear", "transformer", "gru", "tcn"):
        held(f"encoder_{name}", lambda: sequence_encoder_from_name(name, 128, input_dim=768), feats)
    emit({"phase": "ablation", "B": 8, "T": 64, **res})
    return res


def phase_infra():
    """``prefetch_to_device`` onto the card (order kept, array leaves on
    CUDA, other leaves passed, the iterator's error raised);
    ``checkify_step`` finds a NaN planted inside a step on the card and
    nothing in a clean one; ``profile_region``'s name in a torch.profiler
    trace of CUDA work, and ``trace`` writes its file;
    ``ddim_sample_loop(eta=0.5)`` at the prior's full width, card vs CPU on
    the same draws, within 1e-3 of the CPU's largest value."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avi_talking_tpu_torch.data.batching import prefetch_to_device
    from avi_talking_tpu_torch.infra.guards import checkify_step
    from avi_talking_tpu_torch.infra.init import random_module
    from avi_talking_tpu_torch.infra.meters import profile_region, trace
    from avi_talking_tpu_torch.models.diffusion import DiffusionPrior, NoiseScheduler
    from avi_talking_tpu_torch.models.prior_transformer import PriorTransformerNetwork

    def batches():
        for i in range(6):
            yield {"audio": np.full((8, 40960), i, np.float32), "clip": f"clip{i}",
                   "gt": (torch.full((8, 64, 53), float(i)),)}
        raise OSError("the reader failed")

    seen, raised = [], None
    try:
        for b in prefetch_to_device(batches(), size=2):
            check(b["audio"].is_cuda and b["gt"][0].is_cuda, "prefetch left a leaf on the host")
            seen.append((float((b["audio"] * 2).mean()) / 2, float(b["gt"][0].mean()), b["clip"]))
    except OSError as e:
        raised = str(e)
    check(seen == [(float(i), float(i), f"clip{i}") for i in range(6)] and raised,
          f"prefetch_to_device: {seen}, raised {raised}")

    x = torch.tensor([1.0, -1.0, 2.0], device="cuda")
    err, out = checkify_step(lambda t: torch.nan_to_num(torch.log(t)).sum())(x)
    clean, _ = checkify_step(lambda t: torch.log(t).sum())(x.abs())
    check(err.get() is not None and "nan generated by aten.log" in err.get()
          and clean.get() is None and math.isfinite(float(out)),
          f"checkify_step: {err.get()!r}, clean {clean.get()!r}")

    a = torch.randn(512, 512, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with profile_region("flint_profile_region") as region:
            (a @ a).sum()
            torch.cuda.synchronize()
    check(any(e.key == "flint_profile_region" for e in prof.key_averages()),
          "profile_region's range is not in the trace")
    tdir = os.path.join(HERE, "build", "chip_smoke", "trace")
    with trace(tdir):
        (a @ a).sum()
        torch.cuda.synchronize()
    traced = [f for f in os.listdir(tdir) if f.endswith(".pt.trace.json")]
    check(bool(traced), f"trace wrote nothing under {tdir}")

    net = random_module(lambda: PriorTransformerNetwork(), torch.device("cpu"),
                        torch.Generator().manual_seed(61))
    rng = np.random.default_rng(62)
    shape, steps = (4, 1, 128), 20
    text = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    init = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    draws = torch.from_numpy(rng.standard_normal((steps, *shape)).astype(np.float32))
    outs = {}
    with torch.no_grad():
        for dev in ("cpu", "cuda"):
            prior = DiffusionPrior(net=net.to(dev), scheduler=NoiseScheduler.create(100))
            outs[dev] = prior.ddim_sample_loop(shape, text.to(dev), steps=steps, eta=0.5,
                                               noise_init=init, noise_steps=draws).cpu()
        plain = prior.ddim_sample_loop(shape, text.cuda(), steps=steps, noise_init=init).cpu()
    ddim_rel = float((outs["cuda"] - outs["cpu"]).abs().max() / outs["cpu"].abs().max())
    eta_moves = float((outs["cuda"] - plain).abs().max())
    check(ddim_rel < 1e-3 and eta_moves > 1e-3,
          f"ddim eta=0.5 card vs CPU {ddim_rel}, against eta=0 {eta_moves}")
    emit({"phase": "infra", "prefetch_batches": len(seen), "prefetch_error": raised,
          "checkify": err.get(), "profile_region_s": region.elapsed, "trace_files": traced,
          "ddim_eta_rel": ddim_rel, "ddim_eta_vs_deterministic": eta_moves})


def phase_parallel(kb, kras):
    """The data- and tensor-parallel layer (``avi_talking_tpu_torch.parallel``)
    on the one card, each sharded run held against the unsharded one by the
    case functions of ``parallel/dryrun.py`` (gradients within 1e-5 of the
    largest, weights by the 2·lr rule) and here (losses within 1e-6
    relative; served exp / jaw within 1e-6 of the largest value at world 1,
    1e-5 under dp=2, where each rank's rows round by their own batch):

    1. `python -m torch.distributed.run --nproc_per_node 1 -m
       avi_talking_tpu_torch.cli train-prior --dp --steps 4` against the
       command without --dp (started first, run beside 2 and 3);
    2. a two-rank gloo group on this card (NCCL takes one rank a card):
       the prior step at full width (B=256) under dp=2, `use_mesh`
       `generate_batch` at PipelineConfig() on six requests under dp=2, and
       the EMOTE geometric step at EmoteConfig() (B=8, 64 frames) under
       tp=2, where K1 runs on each rank's 6 heads; each rank's launches and
       peak memory;
    3. an in-process NCCL group of world size 1 (a HashStore): the same
       serving, the prior step, the EMOTE step under tp=1 and under FSDP2,
       and the neural-loss step (B=2, 32 frames, renders at 224^2) with
       condition exchange, K1 and K2 under it.
    """
    import torch
    import torch.distributed as dist

    from avi_talking_tpu_torch.parallel import dryrun, init_distributed, make_mesh

    t0 = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": HERE}
    prior = ["-m", "avi_talking_tpu_torch.cli", "train-prior", "--steps", "4"]
    cli = {"plain": subprocess.Popen([sys.executable, *prior], cwd=HERE, env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
           "dp": subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                   "--nproc_per_node", "1", *prior, "--dp"], cwd=HERE, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    try:
        seconds = [3.0, 3.5, 8.0, 9.0, 16.0, 19.0]
        serve = {"tiny": False, "seconds": seconds, "buckets": (64, 128, 256, 512)}
        # a row's GEMMs and convolutions round by the batch it sits in (cuBLAS and
        # cuDNN pick kernels by its size) and the 100-step DDPM loop carries that
        # rounding: one row a rank against two or three read 1.8e-6 of the largest
        # value (PERF.md §6); a wrong row or order is off by the value itself
        serve_dp2 = {**serve, "rtol": 1e-5}
        emote = {"tiny": False, "B": 8, "T": 64}
        t1 = time.perf_counter()
        two = dryrun.run_ranks(2, [
            ("prior_dp2", "prior", (2, 1), {"full": True, "B": 256}),
            ("serve_dp2", "serve", (2, 1), serve_dp2),
            ("emote_tp2", "emote", (1, 2), {**emote, "fsdp": False})],
            "cuda", backend="gloo", workdir=out_dir)
        two_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        init_distributed(backend="nccl", store=dist.HashStore(), rank=0, world_size=1)
        try:
            mesh = make_mesh()
            one = dryrun.run_plan(lambda dp, tp: mesh, "cuda", [
                ("serve_w1", "serve", (1, 1), serve),
                ("prior_w1", "prior", (1, 1), {"full": True, "B": 256}),
                ("emote_w1", "emote", (1, 1), emote),
                ("neural_w1", "neural", (1, 1), {"tiny": False, "B": 2, "T": 32})], {})
        finally:
            dist.destroy_process_group()
        one_s = time.perf_counter() - t1
        finals = {}
        for k, proc in cli.items():
            stdout, stderr = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"train-prior ({k}) exited {proc.returncode}: "
                                        f"{stderr[-2000:]}")
            finals[k] = _final_metrics(stdout)
    finally:
        for proc in cli.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rel = {"prior_dp2": two["prior_dp2"]["loss_dp_rel"],
           "emote_tp2": two["emote_tp2"]["loss_tp_rel"],
           "prior_w1": one["prior_w1"]["loss_dp_rel"],
           "emote_w1_tp": one["emote_w1"]["loss_tp_rel"],
           "emote_w1_fsdp": one["emote_w1"]["loss_fsdp_rel"],
           "neural_w1": one["neural_w1"]["loss_rel"]}
    check(max(rel.values()) <= 1e-6, f"parallel: sharded losses against unsharded {rel}")
    served = {k: r["max_err"] / max(r["largest"], 1.0) for k, r in
              (("serve_dp2", two["serve_dp2"]), ("serve_w1", one["serve_w1"]))}
    check(served["serve_w1"] <= 1e-6 and served["serve_dp2"] <= 1e-5,
          f"parallel: served exp / jaw against unsharded {served}")
    check(set(finals["dp"]) == set(finals["plain"]) and all(
        abs(finals["dp"][k] - v) <= 1e-6 * max(abs(v), 1.0) for k, v in finals["plain"].items()),
        f"train-prior --dp under torch.distributed.run: {finals}")
    k1_tp = [r["emote_tp2"]["launches_tp"]["keybias_attention"] for r in two["by_rank"]]
    check(k1_tp == [12, 12], f"K1 launches a rank under tp=2: {k1_tp}, not 12 each")
    check(two["emote_tp2"]["q_proj_shard"] == (384, 768),
          f"tp=2 q_proj shard {two['emote_tp2']['q_proj_shard']}")
    check(all(r["emote_tp2"]["q_proj_moved"] > 0 for r in two["by_rank"]),
          "a tp rank's q_proj shard did not move")
    k1_serve = [r["serve_dp2"]["launches_sharded"]["keybias_attention"] for r in two["by_rank"]]
    check(k1_serve == [36, 36], f"K1 launches a rank serving six requests: {k1_serve}")
    neural = one["neural_w1"]["launches_sharded"]
    check(neural["keybias_attention"] > 0 and neural["rasterize_tiles_visibility"] > 0,
          f"the neural step launched {neural}")

    def brief(r):
        return {k: v for k, v in r.items() if k not in ("state_tp", "state_dp", "outputs")}

    row = {"phase": "parallel", "losses_rel": rel, "served_rel": served,
           "train_prior_cli": finals, "k1_launches_tp2_by_rank": k1_tp,
           "k1_launches_serve_dp2_by_rank": k1_serve,
           "neural_w1_launches": neural,
           "peak_gib_by_rank": [{k: v["peak_bytes"] / 2 ** 30 for k, v in r.items()}
                                for r in two["by_rank"]],
           "peak_gib_w1": {k: r["peak_bytes"] / 2 ** 30 for k, r in one.items()},
           "two_ranks": {k: brief(r) for k, r in two.items() if k != "by_rank"},
           "world_1": {k: brief(r) for k, r in one.items()},
           "backends": {"two_ranks": "gloo on cuda:0 (both ranks)",
                        "world_1": "nccl (HashStore)"},
           "two_ranks_s": two_s, "world_1_s": one_s, "seconds": time.perf_counter() - t0}
    emit(row)
    return row


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


def check_spec_rows(rows, spec) -> dict:
    """K1's rows at the shapes the specaugment phase's three forwards saw:
    the masked 8 s clip (T=S=199, Wav2Vec2SER's row), the masked batch (B=8
    T=S=64, the EMOTE step's) and resample=False (T=S=399)."""
    out = {}
    for case, key in (("ser_8s", "masked_8s"), ("emote_train", "masked_b8_t64"),
                      ("w2v_native_8s", "native_8s")):
        row = next(r for r in rows if r["case"] == case)
        check(row["shape"] == spec[key]["k1_shape"],
              f"K1 measured at {row['shape']}, the {key} forward runs {spec[key]['k1_shape']}")
        out[key] = row
    return out


def check_ser_row(rows, support) -> dict:
    """K1's row at Wav2Vec2SER's forward, checked against the shape the
    support_nets phase's encoder saw."""
    row = next(r for r in rows if r["case"] == "ser_8s")
    check(row["shape"] == support["k1_shape"],
          f"K1 measured at {row['shape']}, the Wav2Vec2SER forward runs {support['k1_shape']}")
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
    ap.add_argument("--phases",
                    choices=("all", "train", "pirender", "emoca", "preprocess", "flint",
                             "parallel", "faceformer_bf16"),
                    default="all",
                    help="train: only the build, K1's rows, the K1 / K3 gradient rows and the "
                         "EMOTE (geometric and neural), vertex FaceFormer, prior, data-backed, "
                         "PIRender and EMOCA training phases; pirender: only the build and the "
                         "portrait, render-loss and train-pirender phases; emoca: only the build "
                         "and the train-emoca and reconstruct phases; preprocess: only the build "
                         "and the preprocess-mead, BFM and support-net phases; flint: only the "
                         "build and the train-flint, SpecAugment, ablation and infra phases; "
                         "parallel: only the build and the data- / tensor-parallel phase; "
                         "faceformer_bf16: only the build and the bfloat16 FaceFormer phase "
                         "(K3's bfloat16 entry, the attention contract rows)")
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
    phase_s = {}  # wall seconds of each phase function, summed over its calls

    def timed(fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        phase_s[fn.__name__] = phase_s.get(fn.__name__, 0.0) + time.perf_counter() - t0
        return out

    ptxas = timed(phase_build)
    timed(phase_host_codecs)
    rows = timed(phase_kernels, peaks)
    if args.phases == "train":
        timed(phase_attention_grads, peaks)
        timed(phase_kernels_bf16, peaks, cases=BF16_TRAIN)
        timed(phase_attention_grad_bf16, peaks)
        emote = timed(phase_train_emote, kb)
        check_emote_row(rows, emote)
        timed(phase_train_emote_bf16, kb)
        timed(phase_train_emote_neural, kb, kras, peaks, profile=args.profile)
        timed(phase_train_emote_neural_bf16, kb, kras)
        vert = timed(phase_train_faceformer_vert, kb, kba, kras, peaks, profile=args.profile)
        check_vert_row(rows, vert)
        timed(phase_train_prior)
        check_faceformer_row(rows, timed(phase_train_data, kb, kba))
        timed(phase_train_faceformer_render, kb, kba)
        timed(phase_train_pirender)
        timed(phase_train_emoca, kras, peaks)
        if args.profile:
            profile_emote_and_prior_steps()
        emit({"phases": "train", "phase_s": phase_s, "total_s": time.perf_counter() - t_start})
        return finish(name, phases="train")
    if args.phases == "emoca":
        timed(phase_train_emoca, kras, peaks)
        timed(phase_reconstruct, kras, peaks)
        emit({"phases": "emoca", "phase_s": phase_s, "total_s": time.perf_counter() - t_start})
        return finish(name, phases="emoca")
    if args.phases == "preprocess":
        timed(phase_preprocess)
        timed(phase_bfm, kras, peaks)
        timed(phase_support_nets, kb)
        emit({"phases": "preprocess", "phase_s": phase_s,
              "total_s": time.perf_counter() - t_start})
        return finish(name, phases="preprocess")
    if args.phases == "faceformer_bf16":
        timed(phase_faceformer_bf16, kb, kba, peaks)
        emit({"phases": "faceformer_bf16", "phase_s": phase_s,
              "total_s": time.perf_counter() - t_start})
        return finish(name, phases="faceformer_bf16")
    if args.phases == "parallel":
        timed(phase_parallel, kb, kras)
        emit({"phases": "parallel", "phase_s": phase_s,
              "total_s": time.perf_counter() - t_start})
        return finish(name, phases="parallel")
    if args.phases == "flint":
        timed(phase_train_flint)
        check_spec_rows(rows, timed(phase_specaugment, kb))
        timed(phase_ablation)
        timed(phase_infra)
        emit({"phases": "flint", "phase_s": phase_s, "total_s": time.perf_counter() - t_start})
        return finish(name, phases="flint")
    if args.phases == "pirender":
        assets = synthetic_assets(num_vertices=5023, n_shape=300, n_exp=50, num_faces=9976)
        pipe = AviTalkingPipeline.random_init(PipelineConfig(), assets, seed=0)
        timed(phase_portrait, pipe, kb)
        del pipe
        timed(phase_train_faceformer_render, kb, kba)
        timed(phase_train_pirender)
        emit({"phases": "pirender", "phase_s": phase_s,
              "total_s": time.perf_counter() - t_start})
        return finish(name, phases="pirender")
    k3_rows = timed(phase_bias_kernels, peaks)
    grad_rows = timed(phase_attention_grads, peaks)

    t0 = time.perf_counter()
    assets = synthetic_assets(num_vertices=5023, n_shape=300, n_exp=50, num_faces=9976)
    pipe = AviTalkingPipeline.random_init(PipelineConfig(), assets, seed=0)
    emit({"phase": "init", "device": str(pipe.device), "seconds": time.perf_counter() - t0})
    gen_launches, gen_out = timed(phase_generate, pipe, kb)
    timed(phase_generate_batch, pipe, kb)
    timed(phase_diversity, pipe, timed(phase_gpu_vs_cpu, pipe))
    faces = assets.faces.cuda()
    vis_rows = timed(phase_visibility, gen_out["vertices"], faces, peaks,
                     ptxas.get("rasterize_visibility", []))
    render_launches = timed(phase_render, gen_out["vertices"], faces)
    timed(phase_render_gpu_vs_cpu)
    timed(phase_serve, pipe, kb)
    bf16_rows = timed(phase_kernels_bf16, peaks)
    bf16_grad = timed(phase_attention_grad_bf16, peaks)
    bf16_launches, _ = timed(phase_generate_bf16, pipe, kb)
    timed(phase_serve_bf16, kb)
    ckpt_k2 = timed(phase_checkpoint, kb, kras)
    ff_launches = timed(phase_faceformer, kb, kba)
    ff_bf16 = timed(phase_faceformer_bf16, kb, kba, peaks)
    timed(phase_train_faceformer, kb, kba)
    emote = timed(phase_train_emote, kb)
    emote_bf16 = timed(phase_train_emote_bf16, kb)
    neural = timed(phase_train_emote_neural, kb, kras, peaks, profile=args.profile)
    neural_bf16 = timed(phase_train_emote_neural_bf16, kb, kras)
    vert = timed(phase_train_faceformer_vert, kb, kba, kras, peaks, profile=args.profile)
    timed(phase_train_prior)
    data = timed(phase_train_data, kb, kba)
    portrait = timed(phase_portrait, pipe, kb)
    render = timed(phase_train_faceformer_render, kb, kba)
    timed(phase_train_pirender)
    emoca = timed(phase_train_emoca, kras, peaks)
    recon = timed(phase_reconstruct, kras, peaks)
    timed(phase_preprocess)
    bfm = timed(phase_bfm, kras, peaks)
    support = timed(phase_support_nets, kb)
    timed(phase_train_flint)
    spec = timed(phase_specaugment, kb)
    timed(phase_ablation)
    timed(phase_infra)
    parallel = timed(phase_parallel, kb, kras)
    if args.profile:
        timed(phase_profile, pipe, gen_out["vertices"], faces)

    peaks_line = {"variant": variant, "fp32_flops": peaks[0], "bytes_per_s": peaks[1],
                  "tf32_flops": peaks[2], "bf16_flops": peaks[3]}
    bf16_main = bf16_rows[0]  # generate --bf16's shape: B=1, H=12, T=S=200, d=64
    bf16_train = next(r for r in bf16_rows if r["case"] == "emote_train")  # B=8 T=S=64
    main_row = rows[0]  # the generate path's shape: B=1, H=12, T=S=200, d=64
    vis_row = vis_rows[0]  # the render path's launch: 16 frames x 64 tiles
    k3_main = k3_rows[1]  # the forward's self-attention: B=1 H=4 T=S=600 d=32, (H, T, T) bias
    emote_row = check_emote_row(rows, emote)
    neural_row = neural["row"]  # K2 at the predicted video's launch: 2B x T = 128 frames x 16 tiles
    vert_k1 = check_vert_row(rows, vert)  # K1 at train-faceformer-vert's step: B=4 T=S=100
    vert_k3 = vert["k3_rows"][0]  # K3's self-attention at the vertex decoder: B=4 H=4 T=S=100 d=16
    vert_k2 = vert["k2_row"]  # K2 at the emotion loss's launch: 20 frames x 16 tiles
    ff_k1 = check_faceformer_row(rows, data)  # K1 at train-faceformer's step: B=16 T=S=25
    ser_k1 = check_ser_row(rows, support)  # K1 at Wav2Vec2SER's forward: B=1 T=S=199
    spec_k1 = check_spec_rows(rows, spec)  # K1 under the masked and resample=False forwards
    ff_k3 = k3_rows[0]  # K3's self-attention at train-faceformer's step: B=16 H=4 T=S=25 d=32
    tp_row = next(r for r in rows if r["case"] == "emote_train_tp2")  # B=8 H=6 T=S=64: tp=2
    k3_bf16 = ff_bf16["k3_rows"][0]  # K3 bf16's self-attention: B=1 H=4 T=S=600 d=32, (H, T, T)
    k3_bf16_vert = ff_bf16["k3_rows"][3]  # the vertex decoder's: B=4 H=4 T=S=100 d=16
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
        "name": "keybias_attention_bf16",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/keybias_attention_bf16.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:114",
        "path": "train-emote --bf16 (the forward under the gradient; the backward is the "
                "float32 recompute, as JAX's _keybias_bwd)",
        "launches": emote_bf16["launches"],  # the command's run
        "max_abs_err": bf16_train["max_abs_err"],
        "limit_share": max(bf16_train["limit_share"], bf16_train["rms_limit_share"]),
        "ms": bf16_train["ms"],
        "device_ms": bf16_train["device_ms"],
        "library_device_ms": bf16_train["library_device_ms"],
        "plain_ms": bf16_train["plain_ms"],
        "bound_ms": bf16_train["bound_ms"],
        "bound_by": bf16_train["bound_by"],
        "library_ms": bf16_train["library_ms"],
        "shape": bf16_train["shape"],
        "dtype": "bfloat16",
        "backward": {k: v for k, v in bf16_grad.items() if k != "kernel"},
        "peaks": peaks_line,
    }, {
        "name": "keybias_attention_bf16",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/keybias_attention_bf16.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:114",
        "path": "train-emote --neural --bf16 (B=2, 32 frames)",
        "launches": neural_bf16["launches"]["keybias_attention_bf16"],  # the command's run
        "max_abs_err": bf16_train["max_abs_err"],
        "limit_share": max(bf16_train["limit_share"], bf16_train["rms_limit_share"]),
        "ms": bf16_train["ms"],
        "device_ms": bf16_train["device_ms"],
        "library_device_ms": bf16_train["library_device_ms"],
        "plain_ms": bf16_train["plain_ms"],
        "bound_ms": bf16_train["bound_ms"],
        "bound_by": bf16_train["bound_by"],
        "library_ms": bf16_train["library_ms"],
        "shape": bf16_train["shape"],
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
    }] + [{
        "name": "fused_bias_attention_bf16",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/keybias_attention_bf16.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:185",
        "path": path,
        "launches": launches,  # the phase's bfloat16 forward
        "max_abs_err": max(r["max_abs_err"] for r in ff_bf16["k3_rows"]),
        "limit_share": max(max(r["limit_share"], r["rms_limit_share"])
                           for r in ff_bf16["k3_rows"]),
        "ms": row["ms"],
        "device_ms": row["device_ms"],
        "library_device_ms": row["library_device_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "shape": row["shape"],
        "bias_shape": row["bias_shape"],
        "dtype": "bfloat16",
        "peaks": peaks_line,
    } for path, launches, row in (
        ("FaceFormerCoeff(FaceFormerConfig(), dtype=bfloat16) forward (T=600)",
         ff_bf16["coeff"]["forward_launches"]["fused_bias_attention_bf16"], k3_bf16),
        ("FaceFormerVert(FaceFormerVertConfig(), dtype=bfloat16) forward (B=4, T=100)",
         ff_bf16["vert"]["forward_launches"]["fused_bias_attention_bf16"], k3_bf16_vert))] + [{
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
        "name": "rasterize_tiles_visibility",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/rasterize_visibility.cu",
        "replaces": "avi_talking_tpu/ops/pallas/rasterize.py:111",
        "path": "train-emote --neural --bf16 (the float32 render of the predicted video, under "
                "a gradient)",
        "launches": neural_bf16["launches"]["rasterize_tiles_visibility"],  # the command's run
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
    }, {
        "name": "keybias_attention",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/bias_attention.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:114",
        "path": "generate -> portrait (the coefficients' generate; PIRender launches none)",
        "launches": portrait["k1_launches"],  # the phase's generate
        "max_abs_err": main_row["max_abs_err"],
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
        "name": "keybias_attention",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/bias_attention.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:114",
        "path": "train-faceformer --root --render-loss --emo-loss (12 forwards and 12 "
                "recompute backwards a step)",
        "launches": render["launches"]["keybias_attention"],  # the command's run
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
        "path": "train-faceformer --root --render-loss --emo-loss (2 forwards and 2 recompute "
                "backwards a step)",
        "launches": render["launches"]["fused_bias_attention"],  # the command's run
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
    }, {
        "name": "keybias_attention",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/bias_attention.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:114",
        "path": "SpeechEmotionRecognitionPreprocessor -> Wav2Vec2SER (wav2vec2-base, 8 s)",
        "launches": support["k1_launches"],  # the phase's forward
        "max_abs_err": ser_k1["max_abs_err"],
        "ms": ser_k1["ms"],
        "device_ms": ser_k1["device_ms"],
        "library_device_ms": ser_k1["library_device_ms"],
        "plain_ms": ser_k1["plain_ms"],
        "bound_ms": ser_k1["bound_ms"],
        "bound_by": ser_k1["bound_by"],
        "library_ms": ser_k1["library_ms"],
        "shape": ser_k1["shape"],
        "peaks": peaks_line,
    }] + [{
        "name": "keybias_attention",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/bias_attention.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:114",
        "path": path,
        "launches": spec[key]["launches"],  # the phase's forward
        "max_abs_err": spec_k1[key]["max_abs_err"],
        "ms": spec_k1[key]["ms"],
        "device_ms": spec_k1[key]["device_ms"],
        "library_device_ms": spec_k1[key]["library_device_ms"],
        "plain_ms": spec_k1[key]["plain_ms"],
        "bound_ms": spec_k1[key]["bound_ms"],
        "bound_by": spec_k1[key]["bound_by"],
        "library_ms": spec_k1[key]["library_ms"],
        "shape": spec_k1[key]["shape"],
        "peaks": peaks_line,
    } for key, path in (
        ("masked_8s", "Wav2Vec2Model(mask_time_indices=compute_mask_indices(p 0.5, length 2)) "
                      "on 8 s (wav2vec2-base)"),
        ("masked_b8_t64", "Wav2Vec2Model(mask_time_indices) at B=8 over 64 frames "
                          "(wav2vec2-base)"),
        ("native_8s", "Wav2Vec2Model(resample=False) on 8 s (wav2vec2-base, 50 fps)"))] + [{
        "name": "rasterize_tiles_visibility",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/rasterize_visibility.cu",
        "replaces": "avi_talking_tpu/ops/pallas/rasterize.py:111",
        "path": path,
        "launches": launches,  # the command's run
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "device_ms": row["device_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "bound_ms_no_fma": row["bound_ms_no_fma"],
        "library_ms": None,  # no PyTorch call computes z-buffer visibility
        "shape": row["shape"],
        "bin_overflow": row["bin_overflow"],
        "peaks": peaks_line,
    } for path, launches, row in (
        ("train-emoca (the textured render under the coarse step's gradient, 3 steps)",
         emoca["runs"]["coarse"]["launches"], emoca["row"]),
        ("train-emoca --detail (the detail render under the detail step's gradient, 3 steps)",
         emoca["runs"]["detail"]["launches"], emoca["row"]),
        ("reconstruct --detail --textured (the shaded and the textured render of 16 frames)",
         recon["launches"], recon["row"]),
        ("Visualizer3dmmBfm -> render_bfm (16 frames at 224^2 of a 70,688-face BFM09-size mesh, "
         "cap 4096)", bfm["launches"], bfm["row"]))] + [{
        "name": "rasterize_tiles_visibility",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/rasterize_visibility.cu",
        "replaces": "avi_talking_tpu/ops/pallas/rasterize.py:111",
        "path": "parallel: the neural-loss step (B=2, 32 frames, condition exchange) on a "
                "world-1 NCCL mesh",
        "launches": parallel["neural_w1_launches"]["rasterize_tiles_visibility"],
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
        "path": "parallel: the EMOTE step under tp=2 (two ranks on one card through gloo; each "
                "rank's 6 heads)",
        "launches": parallel["k1_launches_tp2_by_rank"][0],  # rank 0's; rank 1 the same
        "max_abs_err": tp_row["max_abs_err"],
        "ms": tp_row["ms"],
        "device_ms": tp_row["device_ms"],
        "library_device_ms": tp_row["library_device_ms"],
        "plain_ms": tp_row["plain_ms"],
        "bound_ms": tp_row["bound_ms"],
        "bound_by": tp_row["bound_by"],
        "library_ms": tp_row["library_ms"],
        "shape": tp_row["shape"],
        "peaks": peaks_line,
    }],
        "keybias_attention_backward": {k: v for k, v in grad_rows[0].items() if k != "kernel"},
        "phase_s": phase_s, "total_s": time.perf_counter() - t_start})
    return finish(name)


if __name__ == "__main__":
    sys.exit(main())
