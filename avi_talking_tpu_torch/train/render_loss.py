"""Stage-1 PIRender render loss, and EmoNet's term on the same renders
(port of ``avi_talking_tpu/train/render_loss.py``).

The reference's ``render2image`` / ``compute_render_loss``: the predicted
coefficients, de-normalised, become PIRender descriptors ``[exp50 |
rot3 | jaw3 | cam3]`` (59-d); for each sampled frame a 27-frame window
(radius 13, edge-clamped) drives the frozen generator on the neutral
reference image, and the warp and final images are held to the frame by
perceptual losses on the UPPER face (2.5 and 4.0; the mouth is the
coefficient and landmark terms' job). With ``emonet`` the same renders feed
EmoNet's feature distance (``compute_emo_loss``; images mapped to [0, 1])
and the call returns ``{"render": ..., "emo": ...}``, which
``FaceFormerTrainer`` weights 0.015 / 0.15.

The batch's images are NHWC, (B, T, H, W, 3) in [-1, 1], as the batch
builders yield them (``img`` / ``ref_img``, or ``images`` /
``ref_images``); the towers see NCHW. The frames are ``frame_idx`` when the
caller or the field gives them, else drawn from the loss's own generator
(JAX draws them from ``PRNGKey(0)`` on every step).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from ..models.pirender import FaceGenerator
from .perceptual import PerceptualLoss


def obtain_seq_index(index: int, num_frames: int, radius: int = 13) -> torch.Tensor:
    """Edge-clamped window indices around ``index``."""
    return (torch.arange(-radius, radius + 1) + int(index)).clamp(0, num_frames - 1)


def upper_face_mask_like(images: torch.Tensor) -> torch.Tensor:
    """(C, H, W) of 1 above the horizontal midline, 0 below, for (…, C, H,
    W) images."""
    C, H, W = images.shape[-3:]
    rows = (torch.arange(H, device=images.device) < H // 2).to(images.dtype)
    return rows[None, :, None].expand(C, H, W)


@dataclasses.dataclass
class PIRenderRenderLoss:
    """``loss(pred_coeff (B, T, d), batch)`` for ``FaceFormerTrainer``:
    batch needs ``pose`` (B, T, >= 3 global rotation), ``cam`` (B, T, 3)
    and the images. The generator, the VGG and EmoNet are frozen here."""

    generator: FaceGenerator
    perceptual_warp: PerceptualLoss
    perceptual_final: PerceptualLoss
    coeff_mean: torch.Tensor
    coeff_std: torch.Tensor
    n_samples: int = 4
    weight_warp: float = 2.5
    weight_final: float = 4.0
    emonet: Any = None  # models.emoca.EmoNetLoss
    frame_idx: Optional[Sequence[int]] = None  # fixed frames on every call
    seed: int = 0

    def __post_init__(self):
        self._draws = torch.Generator().manual_seed(self.seed)
        self.generator.requires_grad_(False)
        for p in (self.perceptual_warp, self.perceptual_final):
            p.model.requires_grad_(False)
        if self.emonet is not None:
            self.emonet.module.requires_grad_(False)

    def __call__(self, pred_coeff: torch.Tensor, batch: Dict[str, torch.Tensor],
                 frame_idx: Optional[Sequence[int]] = None):
        B, T, d = pred_coeff.shape
        unnorm = pred_coeff * self.coeff_std[:d] + self.coeff_mean[:d]
        descr = torch.cat([unnorm[..., :d - 3], batch["pose"][..., :3], unnorm[..., d - 3:],
                           batch["cam"][..., :3]], dim=-1)  # (B, T, 59)
        if frame_idx is None:
            frame_idx = self.frame_idx
        if frame_idx is None:
            frame_idx = torch.randint(0, T, (self.n_samples,), generator=self._draws)
        images = batch["images"] if "images" in batch else batch["img"]
        ref_images = batch["ref_images"] if "ref_images" in batch else batch["ref_img"]

        loss = 0.0
        emo = 0.0
        for i in range(self.n_samples):
            t = int(frame_idx[i])
            window = descr[:, obtain_seq_index(t, T).to(descr.device)]  # (B, 27, 59)
            gt = images[:, t].permute(0, 3, 1, 2)
            ref = ref_images[:, t].permute(0, 3, 1, 2)
            out = self.generator(ref, window.transpose(1, 2))
            mask = upper_face_mask_like(gt)[None]
            loss = loss + self.weight_warp * self.perceptual_warp(out["warp_image"] * mask,
                                                                  gt * mask)
            loss = loss + self.weight_final * self.perceptual_final(out["fake_image"] * mask,
                                                                    gt * mask)
            if self.emonet is not None:
                l_emo, _ = self.emonet(out["fake_image"] * 0.5 + 0.5, gt * 0.5 + 0.5)
                emo = emo + l_emo
        if self.emonet is not None:
            return {"render": loss / self.n_samples, "emo": emo / self.n_samples}
        return loss / self.n_samples
