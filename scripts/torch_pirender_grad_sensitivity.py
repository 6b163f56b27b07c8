#!/usr/bin/env python3
"""How far the gradient of one full-width PIRender training step moves
under rounding alone, on the CPU: float32 against float64.

    python scripts/torch_pirender_grad_sensitivity.py [--stage warp|full]

``FaceGenerator(PIRenderConfig())`` at `train-pirender`'s seeded weights
(seed 0; VGG19 seed 1, five taps at three scales), the batch of
``chip_smoke.py``'s card-vs-CPU step (B=1, 256^2, numpy seed 5): the
generator's gradient of the stage's loss in float32 and in float64. Prints
one JSON line: the rms of the difference over all the weights against the
float64 gradient's rms, and the worst tensor's largest difference against
its largest entry. The L1 terms' signs, VGG's relu masks and the bilinear
warp's pixel edges flip under rounding, so this is the scale a card-vs-CPU
comparison of the step can be held to (``chip_smoke.py``'s
``_warp_step_card_vs_cpu``). Runs on the CPU; no card is needed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from avi_talking_tpu_torch.models.pirender import FaceGenerator, PIRenderConfig
    from avi_talking_tpu_torch.ops.layers import set_compute_dtype
    from avi_talking_tpu_torch.train.perceptual import PerceptualLoss, Vgg19Features

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", choices=("warp", "full"), default="warp")
    args = ap.parse_args()
    rng = np.random.default_rng(5)
    batch = [rng.uniform(-1, 1, (1, 3, 256, 256)), rng.uniform(-1, 1, (1, 3, 256, 256)),
             rng.standard_normal((1, 59, 27))]
    grads = {}
    for dt in (torch.float32, torch.float64):
        gen = set_compute_dtype(FaceGenerator.random_init(PIRenderConfig(), seed=0,
                                                          device="cpu").to(dt), dt)
        vgg = set_compute_dtype(Vgg19Features.random_init(seed=1, device="cpu").to(dt), dt)
        inp, target, window = (torch.from_numpy(a).to(dt) for a in batch)
        warp_only = args.stage == "warp"
        out = gen(inp, window, stage="warp" if warp_only else None)
        loss = 2.5 * PerceptualLoss(vgg)(out["warp_image"], target)
        if not warp_only:
            loss = loss + 4.0 * PerceptualLoss(vgg, use_style_loss=True)(out["fake_image"], target)
        names = [n for n, _ in gen.named_parameters()]
        g = torch.autograd.grad(loss, list(gen.parameters()), allow_unused=True)
        grads[dt] = {n: x.double() for n, x in zip(names, g) if x is not None}
    ref, got = grads[torch.float64], grads[torch.float32]
    num = sum(float(((got[k] - v) ** 2).sum()) for k, v in ref.items())
    den = sum(float((v ** 2).sum()) for v in ref.values())
    worst = max((float((got[k] - v).abs().max() / v.abs().max()), k)
                for k, v in ref.items() if float(v.abs().max()) > 1e-9)
    print(json.dumps({"stage": args.stage, "device": "cpu", "grad_rms_rel_f32_vs_f64":
                      math.sqrt(num / den), "worst_tensor_rel": worst[0],
                      "worst_tensor": worst[1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
