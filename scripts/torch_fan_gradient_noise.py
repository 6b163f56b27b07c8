#!/usr/bin/env python3
"""How far the FAN backbone's gradient in its input image moves, card
against CPU and CPU against itself under a rounding-sized change.

    python scripts/torch_fan_gradient_noise.py

``FanEncoder(224)`` at the seeded weights of ``train-faceformer-vert``
(seed 1, BatchNorm variances 1.5), two random images: the gradient of
sum(backbone_feature ** 2) in the image on the card and on the CPU (TF32
off), and on the CPU again with +-1e-7 added to the image. Prints one JSON
line: each difference as a share of the gradient's largest entry, of its
norm, and the entries past 1e-5 of the largest; then the card's name and
power limit. The 2x2 max-pools route a near-tie's gradient by the last bits
of their inputs; the card test ``test_fan_encoder_card_matches_cpu`` holds
the card to bounds below the CPU's own movement.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_fan_gradient_noise: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from avi_talking_tpu_torch.models.fan_encoder import FanEncoder

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(np.random.default_rng(5).random((2, 3, 224, 224)).astype(np.float32))
    noise = (torch.rand(x.shape, generator=torch.Generator().manual_seed(9)) - 0.5) * 2e-7
    grads = {}
    for key, dev, xin in (("cuda", "cuda", x), ("cpu", "cpu", x), ("cpu_noisy", "cpu", x + noise)):
        m = FanEncoder.random_init(224, seed=1, device=dev)
        with torch.no_grad():
            for name, t in m.named_buffers():
                if name.endswith("running_var"):
                    t.fill_(1.5)
        xi = xin.to(dev).requires_grad_()
        m.backbone_feature(xi).pow(2).sum().backward()
        grads[key] = xi.grad.cpu()

    def diff(a, b):
        return {"max_over_largest": float((a - b).abs().max() / b.abs().max()),
                "l2_over_norm": float((a - b).norm() / b.norm()),
                "entries_past_1e-5_of_largest": int(((a - b).abs() > 1e-5 * b.abs().max()).sum())}

    print(json.dumps({"fan_image_gradient": {
        "card_vs_cpu": diff(grads["cuda"], grads["cpu"]),
        "cpu_vs_cpu_under_1e-7": diff(grads["cpu_noisy"], grads["cpu"]),
        "entries": x.numel()}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
