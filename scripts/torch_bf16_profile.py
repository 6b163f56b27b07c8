#!/usr/bin/env python3
"""Where ``generate --bf16`` spends its time on the card, against float32.

    python scripts/torch_bf16_profile.py [--rounds 4]

Builds the full-width PipelineConfig() pipeline three ways on the same
seeded weights: float32, bfloat16 as the product runs it (every Linear and
Conv casts its float32 weight and bias to bfloat16 at each call, as flax's
``param_dtype`` does), and bfloat16 with those casts taken out (each layer's
bfloat16 weight and bias made once, the same ops otherwise). It then

* times ``generate`` on an 8 s clip for the three in turns (``--rounds``
  rounds, the first a warm-up), host wall seconds;
* profiles one bfloat16 ``generate`` of each kind under torch.profiler: the
  wall, the device's busy time and launches, and the casts of weights
  (``aten::_to_copy`` on a tensor shaped like one of the pipeline's float32
  parameters): their count, host self time and device time.

The difference between the two bfloat16 kinds is what the weight casts cost
end to end. Prints one JSON line per measurement, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def wav_8s():
    import numpy as np

    rng = np.random.default_rng(1)
    t = np.arange(8 * 16000) / 16000.0
    voice = 0.3 * np.sin(2 * np.pi * 180 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (voice + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


def cast_once(pipe) -> int:
    """Give every Linear / Conv1d / ConvTranspose1d of ``pipe`` that computes
    below float32 a forward on bfloat16 copies of its weight and bias made
    now, with the ops of ``ops.layers`` otherwise. Returns how many."""
    import torch
    import torch.nn.functional as F

    from avi_talking_tpu_torch.ops import layers

    def patch(m):
        dt = m.compute_dtype
        w = m.weight.detach().to(dt)
        b = None if m.bias is None else m.bias.detach().to(dt)
        if isinstance(m, layers.Linear):
            def conv(x):
                return F.linear(x.to(dt), w)
        elif isinstance(m, layers.Conv1d):
            def conv(x):
                return m._conv_forward(x.to(dt), w, None)
        else:
            def conv(x):
                return F.conv_transpose1d(x.to(dt), w, None, m.stride, m.padding,
                                          m.output_padding, m.groups, m.dilation)
        bias = None if b is None else (b if isinstance(m, layers.Linear) else b[:, None])

        def forward(x):
            if x.dtype == dt == m.weight.dtype:
                return type(m).forward(m, x)
            y = conv(x)
            return y if bias is None else y + bias
        m.forward = forward

    n = 0
    for part in (pipe.clip_model, pipe.brain, pipe.prior.net, pipe.head):
        for m in part.modules():
            if (isinstance(m, (layers.Linear, layers.Conv1d, layers.ConvTranspose1d))
                    and m.compute_dtype != torch.float32):
                patch(m)
                n += 1
    return n


def profile_generate(pipe, wav, instruction, param_shapes) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    pipe.generate(wav, instruction, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        pipe.generate(wav, instruction, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = launches = 0.0
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            busy += evt.self_device_time_total
            launches += evt.count
    casts = {"count": 0, "host_self_ms": 0.0, "device_ms": 0.0}
    other = {"count": 0, "host_self_ms": 0.0, "device_ms": 0.0}
    for evt in prof.key_averages(group_by_input_shape=True):
        if evt.key != "aten::_to_copy":
            continue
        shape = tuple(evt.input_shapes[0]) if evt.input_shapes and evt.input_shapes[0] else ()
        into = casts if shape in param_shapes else other
        into["count"] += evt.count
        into["host_self_ms"] += evt.self_cpu_time_total / 1e3
        into["device_ms"] += evt.device_time_total / 1e3
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e3 / (wall * 1e3),
            "device_launches": int(launches), "weight_casts": casts, "other_casts": other}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_bf16_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from avi_talking_tpu_torch.core.assets import synthetic_assets
    from avi_talking_tpu_torch.pipeline import AviTalkingPipeline, PipelineConfig

    assets = synthetic_assets(num_vertices=5023, n_shape=300, n_exp=50, num_faces=9976)
    pipes = {"fp32": AviTalkingPipeline.random_init(PipelineConfig(), assets, seed=0),
             "bf16": AviTalkingPipeline.random_init(PipelineConfig(), assets, seed=0,
                                                    dtype=torch.bfloat16),
             "bf16_cast_once": AviTalkingPipeline.random_init(PipelineConfig(), assets, seed=0,
                                                              dtype=torch.bfloat16)}
    patched = cast_once(pipes["bf16_cast_once"])
    param_shapes = {tuple(p.shape) for part in pipes["bf16"].state_dict().values()
                    for p in part.values() if p.dtype == torch.float32}
    wav, instruction = wav_8s(), "A fairly angry man speaks with brow fairly down"
    walls = {k: [] for k in pipes}
    order = []
    for r in range(args.rounds):
        names = list(pipes) if r % 2 == 0 else list(reversed(pipes))
        for k in names:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipes[k].generate(wav, instruction, seed=0)
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
            order.append(k)
    emit({"generate_wall_s_median": {k: statistics.median(v[1:]) for k, v in walls.items()},
          "generate_wall_s_all": walls, "order": order, "audio_s": 8.0,
          "layers_cast_once": patched, "note": "the first round is a warm-up"})
    for k in ("bf16", "bf16_cast_once", "fp32"):
        emit({"profile": k, **profile_generate(pipes[k], wav, instruction, param_shapes)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
