"""EMOTE talking-head training step, geometric losses (port of
``avi_talking_tpu/train/talking_head.py``).

The loss is the JAX trainer's ``_geometric_losses``: exp and jaw MSE, their
velocity terms (weight 10), and the vertex MSE when the head has FLAME
assets and the batch carries ``gt_vertices``; with a ``frame_mask`` (B, T)
the means run over valid frames and a velocity term needs both endpoints
valid. ``disentangle="condition_exchange"`` doubles the batch with the
style conditions exchanged across a derangement; the losses read the
first half. The render-based terms (``NeuralLosses``, ``neural=``) wait for
the neural stage (ROADMAP Queue 1, item 3) and raise.

JAX runs the head with ``deterministic=True`` and hands the whole
variables tree to ``optax.adamw``: so the head stays in ``eval()`` mode
(no dropout; BatchNorm reads its running statistics), and
``emote_trainables`` gives the optimizer every parameter plus the FLINT /
squasher BatchNorm running statistics, which JAX's gradient reaches and
its AdamW moves like weights. The gradient runs through wav2vec2's K1
(the CUDA kernel on the card) and its recompute backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models.conditioning import StyleCondition
from ..models.emote import EmoteTalkingHead
from ..models.flint import RunningStatsBatchNorm1d
from .eval_metrics import condition_exchange

NEURAL_NOT_PORTED = ("the render-based losses (lip reading, EmoNet, video emotion over the "
                     "FixedViewRenderer) are not ported yet (ROADMAP Queue 1, item 3)")


class NeuralLosses:
    """The JAX trainer's frozen perceptual terms; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(NEURAL_NOT_PORTED)


def emote_trainables(head: EmoteTalkingHead) -> List[torch.Tensor]:
    """What JAX's optax.adamw over the head's variables trains: every
    parameter, then the running mean and variance of each BatchNorm, which
    are set to require grad here (BatchNorm's step counter is not a JAX
    variable and stays out)."""
    stats = []
    for mod in head.modules():
        if isinstance(mod, RunningStatsBatchNorm1d):
            stats += [mod.running_mean.requires_grad_(), mod.running_var.requires_grad_()]
    return list(head.parameters()) + stats


def _mmean(err: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of ``err`` (B, T, C), over the frames that weight ``w`` (B, T, 1)
    keeps when given."""
    if w is None:
        return err.mean()
    return (err * w).sum() / (w.sum() * err.shape[-1] + 1e-8)


@dataclasses.dataclass
class TalkingHeadTrainer:
    head: EmoteTalkingHead
    optimizer: torch.optim.Optimizer
    exp_weight: float = 1.0
    jaw_weight: float = 1.0
    vertex_weight: float = 1.0
    velocity_weight: float = 10.0
    neural: Optional[Any] = None
    disentangle: Optional[str] = None  # None | "condition_exchange"

    def __post_init__(self):
        if self.neural is not None:
            raise NotImplementedError(NEURAL_NOT_PORTED)
        if self.disentangle not in (None, "condition_exchange"):
            raise ValueError(f"unknown disentangle mode {self.disentangle!r}")
        self.head.eval()

    def _geometric_losses(self, out, batch, B_eff: int, metrics: Dict[str, torch.Tensor]):
        loss = 0.0
        exp, jaw = out["exp"][:B_eff], out["jaw"][:B_eff]
        mask = batch.get("frame_mask")
        m = mv = None
        if mask is not None:
            m = mask[:B_eff, :, None].to(exp.dtype)  # (B, T, 1)
            mv = m[:, 1:] * m[:, :-1]  # a velocity needs both endpoints
        if "gt_exp" in batch:
            gt = batch["gt_exp"][:B_eff]
            l_exp = _mmean((exp - gt) ** 2, m)
            l_expv = _mmean((exp.diff(dim=1) - gt.diff(dim=1)) ** 2, mv)
            loss = loss + self.exp_weight * l_exp + self.velocity_weight * l_expv
            metrics.update(loss_exp=l_exp, loss_exp_vel=l_expv)
        if "gt_jaw" in batch:
            gt = batch["gt_jaw"][:B_eff]
            l_jaw = _mmean((jaw - gt) ** 2, m)
            l_jawv = _mmean((jaw.diff(dim=1) - gt.diff(dim=1)) ** 2, mv)
            loss = loss + self.jaw_weight * l_jaw + self.velocity_weight * l_jawv
            metrics.update(loss_jaw=l_jaw, loss_jaw_vel=l_jawv)
        if "gt_vertices" in batch and "vertices" in out:
            err_v = (out["vertices"][:B_eff] - batch["gt_vertices"][:B_eff]) ** 2
            if m is None:
                l_v = err_v.mean()
            else:
                l_v = (err_v * m[..., None]).sum() / (
                    m.sum() * err_v.shape[-2] * err_v.shape[-1] + 1e-8)
            loss = loss + self.vertex_weight * l_v
            metrics["loss_vertex"] = l_v
        return loss

    def loss_fn(self, batch: Dict[str, torch.Tensor], perm: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``perm`` (or a draw from ``generator``) is the exchange's
        permutation when ``disentangle`` is set."""
        B_orig = batch["raw_audio"].shape[0]
        if self.disentangle == "condition_exchange":
            batch, perm = condition_exchange(batch, perm=perm, generator=generator)
        cond = StyleCondition(batch["expression"], batch["intensity"], batch["identity"],
                              batch.get("shape"))
        valid_len = None
        if "frame_mask" in batch:  # padded real-data windows
            valid_len = batch["frame_mask"].sum(-1).to(torch.int32)
        out = self.head(batch["raw_audio"], condition=cond, gt_shape=batch.get("gt_shape"),
                        valid_len=valid_len)
        metrics: Dict[str, torch.Tensor] = {}
        loss = self._geometric_losses(out, batch, B_orig, metrics)
        metrics["loss"] = loss
        return loss, metrics

    def train_step(self, batch: Dict[str, torch.Tensor], perm: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step in place; returns the step's metrics (detached)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss_fn(batch, perm, generator)
        loss.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor], perm: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        return self.loss_fn(batch, perm, generator)[1]
