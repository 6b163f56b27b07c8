"""GAN objectives for the PatchGAN discriminators (port of
``avi_talking_tpu/train/gan.py``).

- hinge:   L_D = E[relu(1 - D(x))] + E[relu(1 + D(G(z)))], L_G = -E[D(G(z))]
- lsgan:   MSE against 1 (real) / 0 (fake)
- vanilla: BCE with logits against 1 / 0
- feature matching: the mean L1 over the discriminator's intermediate
  features (not the echoed input, not the logits), averaged over scales.

Each takes a discriminator's output: logits, one feature list, or a
multiscale list of feature lists ``[input, f1, ..., logits]``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F


def _logits(disc_out) -> List[torch.Tensor]:
    if isinstance(disc_out, torch.Tensor):
        return [disc_out]
    if isinstance(disc_out, (list, tuple)) and disc_out and isinstance(disc_out[0], (list, tuple)):
        return [scale[-1] for scale in disc_out]
    return [disc_out[-1]]


def gan_loss_d(real_out, fake_out, mode: str = "hinge") -> torch.Tensor:
    """The discriminator's loss; ``fake_out`` on detached fakes."""
    total = 0.0
    reals, fakes = _logits(real_out), _logits(fake_out)
    for r, f in zip(reals, fakes):
        if mode == "hinge":
            total = total + F.relu(1.0 - r).mean() + F.relu(1.0 + f).mean()
        elif mode == "lsgan":
            total = total + ((r - 1.0) ** 2).mean() + (f ** 2).mean()
        elif mode == "vanilla":
            total = total + F.softplus(-r).mean() + F.softplus(f).mean()
        else:
            raise ValueError(mode)
    return total / len(reals)


def gan_loss_g(fake_out, mode: str = "hinge") -> torch.Tensor:
    """The generator's adversarial loss on D(G(z))."""
    total = 0.0
    fakes = _logits(fake_out)
    for f in fakes:
        if mode == "hinge":
            total = total - f.mean()
        elif mode == "lsgan":
            total = total + ((f - 1.0) ** 2).mean()
        elif mode == "vanilla":
            total = total + F.softplus(-f).mean()
        else:
            raise ValueError(mode)
    return total / len(fakes)


def feature_matching_loss(real_out, fake_out) -> torch.Tensor:
    """pix2pixHD's feature matching: L1 over the intermediate features, the
    real side detached, averaged per scale."""
    if not (isinstance(real_out, (list, tuple)) and real_out
            and isinstance(real_out[0], (list, tuple))):
        real_out, fake_out = [real_out], [fake_out]
    total = 0.0
    for r_scale, f_scale in zip(real_out, fake_out):
        feats = list(zip(r_scale[1:-1], f_scale[1:-1]))
        inner = 0.0
        for r, f in feats:
            inner = inner + (f - r.detach()).abs().mean()
        total = total + inner / max(len(feats), 1)
    return total / len(real_out)
