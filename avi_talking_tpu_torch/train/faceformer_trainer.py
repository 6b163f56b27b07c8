"""Stage-1 FaceFormer training step (port of
``avi_talking_tpu/train/faceformer_trainer.py``).

The loss is the coefficient MSE over the first min(dim, 53) channels,
weighted by ``lip_coeff_weight``. The JAX trainer's other terms need modules
the port does not have yet, and asking for them raises
``NotImplementedError``: the landmark terms (``flame=``) need FLAME
``vertices2landmarks`` and ``train/landmark_losses.py``, the render term
PIRender and the emotion term EmoNet (ROADMAP Queue 1, items 2, 3 and 5).

The gradient runs through wav2vec2's K1 and the decoder's K3 (their
autograd backward is the plain recompute of JAX's ``_keybias_bwd``); the
optimizer is ``train.optim.adamw``, torch's AdamW set to ``optax.adamw``'s
defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models.faceformer import FaceFormerCoeff


@dataclasses.dataclass
class FaceFormerTrainer:
    model: FaceFormerCoeff
    optimizer: torch.optim.Optimizer
    flame: Optional[Any] = None
    lip_coeff_weight: float = 1.0
    render_loss_fn: Optional[Callable] = None
    emo_loss_fn: Optional[Callable] = None

    def __post_init__(self):
        if self.flame is not None:
            raise NotImplementedError(
                "the landmark terms (flame=) are not ported yet: they need FLAME "
                "vertices2landmarks and train/landmark_losses.py (ROADMAP Queue 1, item 2)")
        if self.render_loss_fn is not None:
            raise NotImplementedError(
                "render_loss_fn is not ported yet: it needs PIRender and "
                "train/render_loss.py (ROADMAP Queue 1, item 5)")
        if self.emo_loss_fn is not None:
            raise NotImplementedError(
                "emo_loss_fn is not ported yet: it needs EmoNet and train/emo_cls.py "
                "(ROADMAP Queue 1, items 2 and 3)")

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        pred = self.model(batch["audio"], batch["coeff"], batch.get("eye_embed"),
                          batch.get("emo_embed"), batch.get("ref_coeff"))
        gt = batch["coeff"]
        d = min(pred.shape[-1], 53)
        loss_coeff = ((pred[..., :d] - gt[..., :d]) ** 2).mean()
        loss = self.lip_coeff_weight * loss_coeff
        return loss, {"coeff": loss_coeff, "loss": loss}

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One AdamW step in place; returns the step's metrics (detached)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss_fn(batch)
        loss.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}
