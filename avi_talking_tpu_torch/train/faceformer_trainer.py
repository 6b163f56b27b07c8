"""Stage-1 FaceFormer training step (port of
``avi_talking_tpu/train/faceformer_trainer.py``).

loss = lip_coeff_weight * coefficient MSE over the first min(dim, 53)
channels, plus, with ``flame=``, ldmk_weight * the FLAME landmark terms:
lipd_weight * (lip distance + mouth-corner loss), and eyed_weight * the eye
distance where that weight is set, on the 68-point 2D landmarks of the
de-normalised predicted and ground-truth coefficients (the ground truth's
without a gradient); with ``render_loss_fn`` (``train.render_loss.
PIRenderRenderLoss``: the frozen PIRender's upper-face perceptual terms)
render_weight * its value, and, where it returns ``{"render", "emo"}``
(EmoNet on the same renders), emo_weight * the emotion term; with
``emo_loss_fn`` emo_weight * its value.

The gradient runs through wav2vec2's K1 and the decoder's K3 (their
autograd backward is the plain recompute of JAX's ``_keybias_bwd``); the
optimizer is ``train.optim.adamw``, torch's AdamW set to ``optax.adamw``'s
defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..core.flame import FlameModel
from ..models.faceformer import FaceFormerCoeff
from .landmark_losses import eyed_loss, lipd_loss, mouth_corner_loss


@dataclasses.dataclass
class FaceFormerTrainer:
    model: FaceFormerCoeff
    optimizer: torch.optim.Optimizer
    flame: Optional[FlameModel] = None
    coeff_mean: Optional[torch.Tensor] = None  # (D,) de-normalisation statistics
    coeff_std: Optional[torch.Tensor] = None
    lip_coeff_weight: float = 1.0
    ldmk_weight: float = 10.0
    lipd_weight: float = 1.0
    eyed_weight: float = 0.0
    # (pred_coeff, batch) -> scalar, or {"render": ..., "emo": ...} when the
    # render pass also feeds the EmoNet term (render_loss.PIRenderRenderLoss)
    render_loss_fn: Optional[Callable] = None
    render_weight: float = 0.015
    emo_loss_fn: Optional[Callable] = None
    emo_weight: float = 0.15

    def _denorm(self, coeff: torch.Tensor) -> torch.Tensor:
        if self.coeff_mean is None:
            return coeff
        d = coeff.shape[-1]
        return coeff * self.coeff_std[:d] + self.coeff_mean[:d]

    def _landmarks(self, coeff_norm: torch.Tensor) -> torch.Tensor:
        """Normalised (N, 53+) coefficients -> FLAME 68-point 2D landmarks."""
        ne = self.flame.n_exp
        c = self._denorm(coeff_norm)
        N = c.shape[0]
        pose = torch.cat([c.new_zeros(N, 3), c[:, ne:ne + 3]], dim=1)
        _, lmk2d, _ = self.flame(c.new_zeros(N, self.flame.n_shape), c[:, :ne], pose)
        return lmk2d

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        pred = self.model(batch["audio"], batch["coeff"], batch.get("eye_embed"),
                          batch.get("emo_embed"), batch.get("ref_coeff"))
        gt = batch["coeff"]
        d = min(pred.shape[-1], 53)
        loss_coeff = ((pred[..., :d] - gt[..., :d]) ** 2).mean()
        loss = self.lip_coeff_weight * loss_coeff
        metrics = {"coeff": loss_coeff}
        if self.flame is not None and self.ldmk_weight > 0:
            B, T = pred.shape[:2]
            lmk_pred = self._landmarks(pred.reshape(B * T, -1)[:, :d])
            with torch.no_grad():
                lmk_gt = self._landmarks(gt.reshape(B * T, -1)[:, :d])
            # the lip / eye losses index the 68-point iBUG layout
            if lmk_pred.shape[1] < 68:
                raise ValueError("landmark losses need the 68-point FLAME embedding, got "
                                 f"{lmk_pred.shape[1]} landmarks")
            l_ldmk = self.lipd_weight * (lipd_loss(lmk_pred, lmk_gt)
                                         + mouth_corner_loss(lmk_pred, lmk_gt))
            if self.eyed_weight:
                l_ldmk = l_ldmk + self.eyed_weight * eyed_loss(lmk_pred, lmk_gt)
            loss = loss + self.ldmk_weight * l_ldmk
            metrics["ldmk"] = l_ldmk
        if self.render_loss_fn is not None:
            l_render = self.render_loss_fn(pred, batch)
            if isinstance(l_render, dict):
                loss = loss + self.render_weight * l_render["render"]
                loss = loss + self.emo_weight * l_render["emo"]
                metrics.update(l_render)
            else:
                loss = loss + self.render_weight * l_render
                metrics["render"] = l_render
        if self.emo_loss_fn is not None:
            l_emo = self.emo_loss_fn(pred, batch)
            loss = loss + self.emo_weight * l_emo
            metrics["emo"] = l_emo
        metrics["loss"] = loss
        return loss, metrics

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step in place; returns the step's metrics (detached)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss_fn(batch)
        loss.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}
