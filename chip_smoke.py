#!/usr/bin/env python3
"""Chip check of the PyTorch / CUDA port (avi_talking_tpu_torch) on one card.

    python3 chip_smoke.py              # the check; needs one CUDA card and nvcc
    python3 chip_smoke.py --profile    # also profiles one generate call

Run it from the root of a checkout: it builds the port's CUDA kernels from
the checkout's sources into build/, then

1. build:   every kernel of the generate path, reported in seconds;
2. kernels: each kernel against its plain PyTorch version on the card, at
            the main path's shapes, with its time, the plain version's, one
            PyTorch library call's and the card's lower bound;
3. generate: full-width PipelineConfig() with seeded random weights and
            full-size synthetic FLAME assets on an 8 s clip: shapes,
            finiteness, same seed -> same output, kernel launches, time;
4. generate_batch: six requests over three length buckets;
5. GPU vs CPU: the same weights and explicit noise through the port on the
            card and on the CPU, as an explicit reference;
6. the kernels summary line and the card's name and power limit;
7. the result line.

Each phase prints one JSON line. Any failure raises and the script exits
non-zero without the result line. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# fp32 vector (non tensor core) peak and memory rate by H100 variant
# (NVIDIA data sheets); the SXM part is the default.
PEAKS = {
    "PCIe": (51e12, 2.0e12),
    "NVL": (60e12, 3.9e12),
    "SXM": (67e12, 3.35e12),
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


def keybias_bound(B, H, T, S, d, peaks):
    flops = 4 * B * H * T * S * d
    nbytes = 4 * B * H * (2 * T + 2 * S) * d + 4 * B * S
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


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
    built = build.build(["keybias_attention"])
    build.load("keybias_attention")
    emit({"phase": "build",
          "kernels": {name: {"seconds": b["seconds"],
                             "ptxas": [line.strip() for line in b["log"].splitlines()
                                       if "Used" in line or "spill" in line]}
                      for name, b in built.items()},
          "total_s": time.perf_counter() - t0,
          "tf32": "off: torch.backends.cuda.matmul.allow_tf32 = False, "
                  "torch.backends.cudnn.allow_tf32 = False"})


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
        row = {
            "case": name, "shape": [B, H, T, S, d], "max_abs_err": err, "tol": tol,
            "ms": time_ms(lambda: kb.keybias_attention(q, k, v, bias)),
            "plain_ms": time_ms(lambda: kb.keybias_attention_reference(q, k, v, bias)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=1.0)),
        }
        row["bound_ms"], row["bound_by"], row["flops"], row["bytes"] = keybias_bound(
            B, H, T, S, d, peaks)
        rows.append(row)
        emit({"phase": "kernel_check", "kernel": "keybias_attention", **row})
    return rows


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
    return launches


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


def phase_profile(pipe):
    """The style stage's wall time alone (CLIP, brain, 100-step prior), then
    one generate call under torch.profiler: device time by kernel and the
    device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    wav = synthetic_wav(8.0, seed=1)
    instruction = "A fairly angry man speaks with brow fairly down"
    pipe.generate(wav, "warm up", seed=0)
    style_walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        pipe.sample_style(instruction, seed=0)
        torch.cuda.synchronize()
        style_walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.generate(wav, instruction, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for evt in prof.key_averages():
        # device-side rows only (kernels, copies); CPU op rows repeat their time
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((evt.self_device_time_total, evt.key, evt.count))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    emit({"phase": "profile", "style_wall_ms_median": statistics.median(style_walls) * 1e3,
          "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
          "device_launches": sum(k[2] for k in kernels),
          "top": [{"kernel": k[:90], "ms": t / 1e3, "count": n} for t, k, n in kernels[:15]]})


def main() -> int:
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
    from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb
    from avi_talking_tpu_torch.pipeline import AviTalkingPipeline, PipelineConfig

    name = torch.cuda.get_device_name(0)
    variant, peaks = card_peaks(name)
    phase_build()
    rows = phase_kernels(peaks)

    t0 = time.perf_counter()
    pipe = AviTalkingPipeline.random_init(
        PipelineConfig(), synthetic_assets(num_vertices=5023, n_shape=300, n_exp=50,
                                           num_faces=9976), seed=0)
    emit({"phase": "init", "device": str(pipe.device), "seconds": time.perf_counter() - t0})
    gen_launches = phase_generate(pipe, kb)
    phase_generate_batch(pipe, kb)
    phase_gpu_vs_cpu(pipe)
    if "--profile" in sys.argv[1:]:
        phase_profile(pipe)

    main_row = rows[0]  # the generate path's shape: B=1, H=12, T=S=200, d=64
    emit({"kernels": [{
        "name": "keybias_attention",
        "route": "cuda",
        "source": "avi_talking_tpu_torch/csrc/keybias_attention.cu",
        "replaces": "avi_talking_tpu/ops/pallas/attention.py:114",
        "launches": gen_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
        "peaks": {"variant": variant, "fp32_flops": peaks[0], "bytes_per_s": peaks[1]},
    }], "total_s": time.perf_counter() - t_start})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
