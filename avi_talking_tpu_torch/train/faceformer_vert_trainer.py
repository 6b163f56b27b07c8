"""The vertex-space FaceFormer's training step, as the JAX command
``train-faceformer-vert`` composes it (``avi_talking_tpu/cli/
train_faceformer_vert.py``: its ``loss_fn``, ``step`` and ``pre_step``).

terms = {"verts": teacher-forced vertex MSE}, or with ``selector`` the
disentangle terms (``models.faceformer_vert.disentangle_losses``: the base
MSE and the eye / mouth region MSEs under shuffled audio / emotion), plus
with ``emo_cls`` 0.1 x the rendered emotion cross-entropy of the
teacher-forced prediction under the batch's one-hot; the loss is their sum,
one ``optax.adam`` step (``train.optim.adam``) a call.

The emotion term's prediction: without ``selector`` it is the same function
of the same inputs as the MSE's prediction and is shared. With it, JAX
applies the model a fourth time: the disentangle losses' base prediction
takes the style of subject 0 (``one_hot=None``), the emotion term the
batch's one-hot (zeros for MEAD), so the two differ and both are computed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..models.faceformer_vert import FaceFormerVert, FlameRegionSelector, disentangle_losses
from .emo_cls import EmoClsHead, EmoClsLoss


@dataclasses.dataclass
class FaceFormerVertTrainer:
    model: FaceFormerVert
    optimizer: torch.optim.Optimizer
    to_verts: Callable[[torch.Tensor], torch.Tensor]  # payload -> (B, T, V*3) vertices
    selector: Optional[FlameRegionSelector] = None  # the disentangle terms when set
    emo_cls: Optional[EmoClsLoss] = None

    def loss_fn(self, audio, payload, one_hot, emo, emo_idx,
                generator: Optional[torch.Generator] = None,
                perms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``perms`` (emotion, audio permutations) as ``disentangle_losses``
        takes them; without them they are drawn from ``generator``."""
        with torch.no_grad():  # data: the payload takes no gradient
            verts = self.to_verts(payload)
        pred = None
        if self.selector is not None:
            terms = disentangle_losses(self.model, audio, verts, emo, self.selector,
                                       generator=generator, perms=perms)
        else:
            pred = self.model(audio, verts, emo, one_hot)
            terms = {"verts": ((pred - verts) ** 2).mean()}
        if self.emo_cls is not None:
            if pred is None:
                pred = self.model(audio, verts, emo, one_hot)
            terms["emo_cls"] = 0.1 * self.emo_cls(pred, emo_idx)
        return sum(terms.values()), terms

    def train_step(self, *batch, generator=None, perms=None) -> Dict[str, torch.Tensor]:
        """One step in place on (audio, payload, one_hot, emo, emo_idx);
        returns the terms (detached)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, terms = self.loss_fn(*batch, generator=generator, perms=perms)
        loss.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in terms.items()}


@dataclasses.dataclass
class EmoClsPretrainer:
    """The pretrain stage: only the head learns, on renders of the
    ground-truth vertices of every frame (``emo_cls.stride`` 1), the render
    and FAN run without a gradient. ``optimizer`` holds
    ``emo_cls.emo_cls_trainables(head)``."""

    emo_cls: EmoClsLoss
    head: EmoClsHead
    optimizer: torch.optim.Optimizer
    to_verts: Callable[[torch.Tensor], torch.Tensor]

    def train_step(self, payload: torch.Tensor, emo_idx: torch.Tensor) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            verts = self.to_verts(payload)
        loss = self.emo_cls(verts, emo_idx, head=self.head)
        loss.backward()
        self.optimizer.step()
        return loss.detach()
