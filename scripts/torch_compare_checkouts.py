#!/usr/bin/env python3
"""Compare two checkouts of the port on one card, in turns.

    python scripts/torch_compare_checkouts.py OTHER_ROOT [--order ABBA]

A is the checkout at OTHER_ROOT (say a parent commit unpacked with
``git archive`` into a directory that .gitignore lists), B this one. Each
letter of ``--order`` runs one side in a process of its own, which imports
the port from that side's root and builds its kernels there, then measures:

* K1 / K3 at chip_smoke.py's kernel-check shapes, K1's bfloat16 entry at
  its bf16 kernel-check shapes (chip_smoke.BF16_CASES, the generate path's
  four, and BF16_STREAMED, K and V streamed; keys ``bf16_<case>``), K3's
  bfloat16 entry at the FaceFormer family's (chip_smoke.K3_BF16_CASES, the
  float32 (H, T, T) and (T, S) biases) and at the attention contract's
  timed d=8 case (B=2 H=4 T=37 S=45, a bfloat16 (H, T, S) bias, a fifth of
  it -1e9; keys ``bf16_k3_<case>``), and K2 at its three
  visibility shapes (chip_smoke.visibility_cases: the render path's launch
  on the 8 s clip's frames, the head mesh at 256^2 / tile 32 and 224^2 /
  tile 56): CUDA-event ms around the wrapper and the kernel's device ms
  under torch.profiler; and K2's device ms summed over one ``render_verts``
  of the 8 s clip's 200 frames (13 launches);
* ``generate`` on the 8 s clip, full-width PipelineConfig() (median of 5);
* ``render_verts`` of that clip's 200 frames at 256^2 (median of 3);
* the full-width FaceFormer forward (median of 5) and ``predict`` (median
  of 3) at B=1, T=600;
* the training step at train-faceformer's defaults, B=16, T=25 (median and
  mean of 25 after 3 warm-up steps).

With ``--kernels`` a side times the kernels only. Each side prints one
JSON line and saves its K3 bfloat16 outputs under build/compare_outputs/;
the last lines give every metric's values per side, in run order, the max
|A - B| of those outputs per case, and the card's name and power limit. The helpers
(timers, inputs, seeded models) are this checkout's chip_smoke.py for both
sides, so both are measured the same way.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUTPUTS = os.path.join(ROOT, "build", "compare_outputs")  # each side's K3 bf16 outputs

CASES = [  # chip_smoke.py's kernel_check shapes: name, B, H, T=S, d, bias
    ("generate", 1, 12, 200, 64, "key"), ("batch_512", 2, 12, 512, 64, "key"),
    ("ragged_333", 1, 12, 333, 64, "key"), ("faceformer_600", 1, 12, 600, 64, "key"),
    ("train_self_HTT", 16, 4, 25, 32, "HTT"), ("forward_self_HTT", 1, 4, 600, 32, "HTT"),
    ("forward_cross_TS", 1, 4, 600, 32, "TS"), ("vert_self_HTT_d16", 1, 4, 600, 16, "HTT"),
]


def side(root: str, label: str, kernels_only: bool) -> dict:
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from avi_talking_tpu_torch.ops.kernels import bias_attention as kba
    from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb
    from avi_talking_tpu_torch.ops.kernels import rasterize as kras
    from avi_talking_tpu_torch.ops.positional import enc_dec_alignment_bias, faceformer_bias
    from avi_talking_tpu_torch.core.assets import synthetic_assets
    from avi_talking_tpu_torch.pipeline import AviTalkingPipeline, PipelineConfig
    from avi_talking_tpu_torch.viz import FlameVisualizer

    if not kb.__file__.startswith(root):
        raise SystemExit(f"imported the port from {kb.__file__}, not from {root}")
    cs.phase_build()  # builds this side's kernels; TF32 off in matmuls and convolutions
    result = {"side": label, "root": root, "kernels": {}}
    g = torch.Generator(device="cuda").manual_seed(0)
    for case, B, H, T, d, kind in CASES:
        q = torch.randn(B, H, T, d, device="cuda", generator=g) * d ** -0.5
        k = torch.randn(B, H, T, d, device="cuda", generator=g)
        v = torch.randn(B, H, T, d, device="cuda", generator=g)
        if kind == "key":
            lens = torch.tensor([T] + [T * 3 // 5] * (B - 1), device="cuda")
            bias = torch.where(torch.arange(T, device="cuda")[None] < lens[:, None], 0.0, -1e9)

            def fn():
                return kb.keybias_attention(q, k, v, bias)
        else:
            bias = (faceformer_bias(H, T, 25, device="cuda") if kind == "HTT"
                    else enc_dec_alignment_bias(T, T, device="cuda"))

            def fn():
                return kba.fused_bias_attention(q, k, v, bias)
        result["kernels"][case] = {"ms": cs.time_ms(fn),
                                   "device_ms": cs.device_ms(fn, "bias_attention_kernel")}
    gb = torch.Generator(device="cuda").manual_seed(1)
    for case, B, H, T, S, d, lens in cs.BF16_CASES + cs.BF16_STREAMED:
        qb, kb16, vb, biasb = cs.bf16_inputs(B, H, T, S, d, lens, gb)

        def fn():
            return kb.keybias_attention(qb, kb16, vb, biasb)

        result["kernels"][f"bf16_{case}"] = {
            "ms": cs.time_ms(fn), "device_ms": cs.device_ms(fn, "keybias_attention_bf16_kernel")}
    gb = torch.Generator(device="cuda").manual_seed(13)
    os.makedirs(OUTPUTS, exist_ok=True)
    k3_cases = [(case, cs.k3_bf16_inputs(B, H, T, d, kind, gb))
                for case, B, H, T, d, kind in cs.K3_BF16_CASES]
    B, H, T, S, d = 2, 4, 37, 45, 8
    k3_cases.append(("contract_d8", (
        (torch.randn(B, H, T, d, device="cuda", generator=gb) * d ** -0.5).bfloat16(),
        torch.randn(B, H, S, d, device="cuda", generator=gb).bfloat16(),
        torch.randn(B, H, S, d, device="cuda", generator=gb).bfloat16(),
        torch.where(torch.rand(H, T, S, device="cuda", generator=gb) < 0.2, -1e9,
                    torch.randn(H, T, S, device="cuda", generator=gb)).bfloat16())))
    for case, (qb, kb16, vb, biasb) in k3_cases:

        def fn():
            return kba.fused_bias_attention(qb, kb16, vb, biasb)

        torch.save(fn().cpu(), os.path.join(OUTPUTS, f"{label}_bf16_k3_{case}.pt"))
        result["kernels"][f"bf16_k3_{case}"] = {
            "ms": cs.time_ms(fn), "device_ms": cs.device_ms(fn, "keybias_attention_bf16_kernel")}

    assets = synthetic_assets(num_vertices=5023, n_shape=300, n_exp=50, num_faces=9976)
    pipe = AviTalkingPipeline.random_init(PipelineConfig(), assets, seed=0)
    wav = cs.synthetic_wav(8.0, seed=1)
    instruction = "A fairly angry man speaks with brow fairly down"
    verts = pipe.generate(wav, instruction, seed=0)["vertices"]
    faces = assets.faces.cuda()
    for case, tri, valid, px, py, *_ in cs.visibility_cases(verts, faces):

        def fn():
            return kras.rasterize_tiles_visibility(tri, valid, px, py)

        result["kernels"][case] = {"ms": cs.time_ms(fn, iters=10, reps=5),
                                   "device_ms": cs.device_ms(fn, "rasterize_visibility")}
    viz = FlameVisualizer(faces, 256)
    result["kernels"]["render_verts"] = {"k2_device_ms": cs.device_ms(
        lambda: viz.render_verts(verts), "rasterize_visibility", iters=3)}
    if kernels_only:
        return result

    from avi_talking_tpu_torch.cli.train import synthetic_batches
    from avi_talking_tpu_torch.models.faceformer import FaceFormerConfig
    from avi_talking_tpu_torch.train.faceformer_trainer import FaceFormerTrainer, adamw

    def walls(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    result["generate_s"] = walls(lambda: pipe.generate(wav, instruction, seed=0), 5)
    del pipe
    result["render_s"] = walls(lambda: viz.render_verts(verts), 3)

    cfg = FaceFormerConfig()
    model = cs._faceformer_model(cfg, seed=0, device="cuda")
    audio, coeffs, eye, emo, ref = cs._faceformer_inputs(cfg, 1, 600, seed=20, device="cuda")
    with torch.no_grad():
        model(audio, coeffs, eye, emo, ref)
        result["forward_s"] = walls(lambda: model(audio, coeffs, eye, emo, ref), 5)
        result["predict_s"] = walls(lambda: model.predict(audio, 600, eye, emo, ref), 3)
    del model

    model = cs._faceformer_model(cfg, seed=0, device="cuda")
    trainer = FaceFormerTrainer(model=model, optimizer=adamw(model.parameters(), 1e-4))
    batches = synthetic_batches(cfg, 16, 25, seed=0, device="cuda")
    for _ in range(3):
        trainer.train_step(next(batches))
    todo = iter([next(batches) for _ in range(25)])  # made before the clock runs
    result["train_step_s"] = walls(lambda: trainer.train_step(next(todo)), 25)
    return result


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("other_root", nargs="?")
    p.add_argument("--order", default="ABBA")
    p.add_argument("--kernels", action="store_true", help="time the kernels only")
    p.add_argument("--side", nargs=2, metavar=("ROOT", "LABEL"), help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.side:
        print("SIDE " + json.dumps(side(os.path.abspath(args.side[0]), args.side[1],
                                        args.kernels)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_compare_checkouts: no CUDA device", file=sys.stderr)
        return 2
    roots = {"A": os.path.abspath(args.other_root), "B": ROOT}
    shutil.rmtree(OUTPUTS, ignore_errors=True)
    runs = []
    for label in args.order:
        cmd = [sys.executable, os.path.abspath(__file__), "--side", roots[label], label]
        out = subprocess.run(cmd + ["--kernels"] * args.kernels, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        line = [x for x in out.stdout.splitlines() if x.startswith("SIDE ")][-1][5:]
        print(line, flush=True)
        runs.append(json.loads(line))
    summary = {}
    walls = () if args.kernels else ("generate_s", "render_s", "forward_s", "predict_s",
                                     "train_step_s")
    for r in runs:
        for case, row in r["kernels"].items():
            for key, val in row.items():
                summary.setdefault(f"{case}.{key}", {}).setdefault(r["side"], []).append(val)
        for key in walls:
            med = summary.setdefault(f"{key}.median", {}).setdefault(r["side"], [])
            med.append(statistics.median(r[key]))
            if key == "train_step_s":
                summary.setdefault(f"{key}.mean", {}).setdefault(r["side"], []).append(
                    statistics.mean(r[key]))
    print(json.dumps({"summary": summary, "order": args.order, "A": roots["A"], "B": roots["B"]}))
    if {"A", "B"} <= set(args.order):
        diff = {}
        for name in sorted(os.listdir(OUTPUTS)):
            if name.startswith("A_"):
                a, b = (torch.load(os.path.join(OUTPUTS, x + name[1:])).float() for x in "AB")
                diff[name[2:-3]] = float((a - b).abs().max())
        print(json.dumps({"max_abs_diff_A_B": diff}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
