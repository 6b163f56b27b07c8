"""PIRender training: the warp pretrain, then the full editing stage
(port of ``avi_talking_tpu/train/pirender_trainer.py``).

The reference's ``FaceTrainer`` with ``flame_wo_crop.yaml``'s trainer
block: for the first ``pretrain_warp_steps`` steps only the warp path is
trained (perceptual, weight 2.5); then the editing net joins (perceptual
weight 4 and the gram style term); optionally a hinge GAN with feature
matching on the editing stage, with its own discriminator step. Adam
(0.5, 0.999) at 1e-4 with a staircase decay of 0.2 every 300k steps.

optax keeps one step count for every parameter, and in the warp stage JAX
gives the editing net zero gradients, so its count advances with the rest.
``torch.optim.Adam`` skips a parameter whose ``.grad`` is None and counts
its steps per parameter, which would bias-correct the editing net's first
full-stage update as step 1 (about 4.9x smaller than optax's after 100
warp steps). So every parameter stays in the optimizer and a step gives
each one its gradient, zero where the loss does not reach it.

Batches are NCHW: ``input_image`` / ``target_image`` (B, 3, H, W) in
[-1, 1], ``coeff_window`` (B, coeff_nc, 27).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from ..models.pirender import FaceGenerator
from .gan import feature_matching_loss, gan_loss_d, gan_loss_g
from .perceptual import PerceptualLoss


def make_pirender_optimizer(params: Iterable[torch.Tensor], lr: float = 1e-4,
                            step_size: int = 300_000, gamma: float = 0.2
                            ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """``optax.adam(exponential_decay(lr, step_size, gamma, staircase=True),
    b1=0.5, b2=0.999)``: Adam and its schedule, stepped once an update."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.5, 0.999), eps=1e-8, weight_decay=0.0)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda s: gamma ** (s // step_size))


def _step(optimizer: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    """One update, every parameter of ``optimizer`` given its gradient (zero
    where ``loss`` does not reach it)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    optimizer.step()


@dataclasses.dataclass
class PIRenderTrainer:
    generator: FaceGenerator
    optimizer: torch.optim.Optimizer  # over every generator parameter
    perceptual_warp: PerceptualLoss  # no style term
    perceptual_final: PerceptualLoss  # with the style term (weight 250)
    scheduler: Any = None
    weight_perceptual_warp: float = 2.5
    weight_perceptual_final: float = 4.0
    pretrain_warp_steps: int = 200_000
    # the optional adversarial term: a discriminator (models.discriminator.
    # MultiscaleDiscriminator) and its optimizer enable a hinge GAN with
    # feature matching on the editing stage
    discriminator: Any = None
    optimizer_d: Optional[torch.optim.Optimizer] = None
    weight_gan: float = 1.0
    weight_feature_matching: float = 10.0
    gan_mode: str = "hinge"

    def loss_fn(self, batch: Dict[str, torch.Tensor], warp_only: bool, use_gan: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        out = self.generator(batch["input_image"], batch["coeff_window"],
                             stage="warp" if warp_only else None)
        target = batch["target_image"]
        l_warp = self.perceptual_warp(out["warp_image"], target)
        loss = self.weight_perceptual_warp * l_warp
        metrics = {"perceptual_warp": l_warp}
        if not warp_only:
            l_final = self.perceptual_final(out["fake_image"], target)
            loss = loss + self.weight_perceptual_final * l_final
            metrics["perceptual_final"] = l_final
            if use_gan:
                fake_out = self.discriminator(out["fake_image"])
                real_out = self.discriminator(target)
                l_gan = gan_loss_g(fake_out, self.gan_mode)
                l_fm = feature_matching_loss(real_out, fake_out)
                loss = loss + self.weight_gan * l_gan + self.weight_feature_matching * l_fm
                metrics.update(gan_g=l_gan, feature_matching=l_fm)
        metrics["loss"] = loss
        return loss, metrics

    def train_step(self, batch: Dict[str, torch.Tensor], warp_only: bool,
                   use_gan: bool = False) -> Dict[str, torch.Tensor]:
        """One generator update; ``use_gan`` adds the adversarial terms
        (the editing stage only). Returns the metrics, detached."""
        loss, metrics = self.loss_fn(batch, warp_only, use_gan and not warp_only)
        _step(self.optimizer, loss)
        if self.scheduler is not None:
            self.scheduler.step()
        return {k: v.detach() for k, v in metrics.items()}

    def d_loss_fn(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The discriminator's objective on the generator's detached fakes."""
        with torch.no_grad():
            fake = self.generator(batch["input_image"], batch["coeff_window"])["fake_image"]
        return gan_loss_d(self.discriminator(batch["target_image"]), self.discriminator(fake),
                          self.gan_mode)

    def d_train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        loss = self.d_loss_fn(batch)
        _step(self.optimizer_d, loss)
        return loss.detach()
