"""Diffusion-prior training step (port of ``avi_talking_tpu/train/prior.py``).

loss = soft_clip_loss(projected text embedding, style) + 30 x the prior's
x0 MSE. The optimizer is JAX's ``optax.chain(clip_by_global_norm(1.0),
adamw(one_cycle_schedule, weight_decay=1e-2, mask=_no_decay_mask))``:
``PriorOptimizer`` clips to optax's rule (scale by max / norm only when the
norm reaches max, no epsilon), sets the learning rate from the schedule at
the update count before the update (0 on the first step, as optax reads
its count), and steps a torch AdamW whose two parameter groups are the
decayed tensors and the rest (biases, norm scales, anything in a norm).

The step's random draws (the brain's dropout masks, the timesteps, the
noise and the two condition keep masks) are taken from ``draws`` where
given (a test passes JAX's) and from a ``torch.Generator`` otherwise.

With ``mesh`` (``parallel.make_mesh``) each rank steps on its own rows of
the global batch: the draws are made for the global batch, from the same
generator on every rank, and sliced; the contrastive term and the top-1
metrics run over the global batch through a differentiable gather; the
gradients are averaged over dp before the clip, so the step is the
unsharded one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.brain import BrainNetwork
from ..models.diffusion import DiffusionPrior
from ..models.prior_transformer import LucidLayerNorm
from ..parallel.mesh import batch_sharding, dp_gather, dp_mean, dp_size, draw_rows, reduce_gradients
from .losses import batchwise_cosine_similarity, soft_clip_loss, topk_accuracy

Schedule = Callable[[int], float]
DRAW_KEYS = ("dropout", "times", "noise", "brain_keep", "image_keep")


def one_cycle_schedule(max_lr: float, total_steps: int, pct_start: float = 0.3,
                       div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    """optax's ``cosine_onecycle_schedule`` after JAX's clamp: ``pct_start``
    held within [1 / total, (total - 1) / total] so both phases span a step,
    and a constant ``max_lr`` for totals below 2. In float64, as torch keeps
    a learning rate: optax evaluates the same formula in float32 under jit,
    where the cosine's cancellation near a phase's end costs it up to
    2e-4 of the value. It is not torch's ``OneCycleLR``, whose phase ends
    and step count differ."""
    if total_steps < 2:
        return lambda count: max_lr
    pct_start = min(max(pct_start, 1.0 / total_steps), (total_steps - 1.0) / total_steps)
    bounds = [0, int(pct_start * total_steps), int(total_steps)]
    values = np.cumprod([max_lr / div_factor, div_factor, 1.0 / (div_factor * final_div_factor)])

    def schedule(count: int) -> float:
        for j in range(2):
            if bounds[j] <= count < bounds[j + 1]:
                pct = (count - bounds[j]) / (bounds[j + 1] - bounds[j])
                start, end = values[j], values[j + 1]
                return float(end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1))
        return float(values[-1])

    return schedule


def decay_groups(modules: Iterable[nn.Module]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(decayed, not decayed) parameters of ``modules``: JAX's
    ``_no_decay_mask`` on the port's names: no decay for biases and for
    every parameter of a norm (LayerNorm weight and bias, the prior's
    gain-only norms)."""
    decay, no_decay = [], []
    for module in modules:
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                skip = name == "bias" or isinstance(mod, (nn.LayerNorm, LucidLayerNorm))
                (no_decay if skip else decay).append(p)
    return decay, no_decay


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: when the global norm is at
    least ``max_norm`` every gradient is scaled by max_norm / norm (optax
    divides, then multiplies: the same to a rounding); returns the norm.
    The squares are summed in float64: torch's float32 norm on the CPU
    drifts far past float32's rounding over a 4096 x 4096 gradient, and the
    card's reduction would not drift the same way. Two foreach launches
    and no host synchronisation."""
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads, 2.0, dtype=torch.float64))).float()
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0, max_norm / norm))
    return norm


@dataclasses.dataclass
class PriorOptimizer:
    """An AdamW whose every group takes ``schedule(count)`` as its learning
    rate, after an optional global-norm clip of the gradients."""

    adamw: torch.optim.Optimizer
    schedule: Schedule
    max_grad_norm: Optional[float] = None

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self, count: int) -> None:
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(count)
        if self.max_grad_norm is not None:
            grads = [p.grad for g in self.adamw.param_groups for p in g["params"]
                     if p.grad is not None]
            clip_by_global_norm_(grads, self.max_grad_norm)
        self.adamw.step()


def make_prior_optimizer(brain: BrainNetwork, prior: DiffusionPrior, max_lr: float = 1e-4,
                         total_steps: int = 10_000, weight_decay: float = 1e-2
                         ) -> Tuple[PriorOptimizer, Schedule]:
    sched = one_cycle_schedule(max_lr, total_steps)
    decay, no_decay = decay_groups([brain, prior.net])
    adamw = torch.optim.AdamW([{"params": decay, "weight_decay": weight_decay},
                               {"params": no_decay, "weight_decay": 0.0}],
                              lr=max_lr, betas=(0.9, 0.999), eps=1e-8)
    return PriorOptimizer(adamw, sched, max_grad_norm=1.0), sched


@dataclasses.dataclass
class PriorTrainState:
    """JAX's (params, opt_state, step): the brain, the diffusion prior (its
    network holds the weights), the optimizer and the steps taken."""

    brain: BrainNetwork
    prior: DiffusionPrior
    optimizer: PriorOptimizer
    step: int = 0

    def state_dict(self) -> Dict:
        return {"brain": self.brain.state_dict(), "prior": self.prior.net.state_dict(),
                "optimizer": self.optimizer.adamw.state_dict(), "step": self.step}

    def load_state_dict(self, sd: Dict) -> None:
        self.brain.load_state_dict(sd["brain"])
        self.prior.net.load_state_dict(sd["prior"])
        self.optimizer.adamw.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-8)


def step_draws(state: PriorTrainState, B: int, generator: torch.Generator, tokens: int = 1
               ) -> Dict[str, Any]:
    """Every draw of a step for a batch of ``B``, in the order the step
    would take them from ``generator``: the brain's dropout masks, the
    timesteps, the noise, then the brain's and the image's keep masks
    (None where the drop probability leaves nothing to draw)."""
    dev = generator.device
    prior = state.prior

    def keep(p):
        return torch.rand((B, 1, 1), generator=generator, device=dev) >= p if 0.0 < p < 1.0 \
            else None

    draws = {"dropout": state.brain.dropout_masks(B, generator),
             "times": torch.randint(0, prior.scheduler.num_timesteps, (B,), generator=generator,
                                    device=dev),
             "noise": torch.randn((B, tokens, prior.net.dim), generator=generator, device=dev)}
    draws["brain_keep"] = keep(prior.text_cond_drop_prob)
    draws["image_keep"] = keep(prior.image_cond_drop_prob)
    return draws


@dataclasses.dataclass
class PriorTrainer:
    prior_loss_weight: float = 30.0
    nce_temp: float = 0.006  # the driver anneals it 0.004 -> 0.0075
    mesh: Any = None  # a ("dp", "tp") DeviceMesh: dp over the batch

    def loss_fn(self, state: PriorTrainState, voxel: torch.Tensor, style_target: torch.Tensor,
                nce_temp: Optional[float] = None, draws: Optional[Dict] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``voxel`` (B, in_dim) CLIP text means, ``style_target`` (B, 128)
        style embeddings (under a mesh this rank's rows, and ``draws`` those
        of the global batch); the brain runs with dropout, the prior with
        condition dropout. Under a mesh the loss is this rank's share: its
        prior MSE and the global contrastive term, whose mean over the dp
        ranks is the global loss, as the metrics are."""
        d = draws or {}
        if generator is None and any(k not in d for k in DRAW_KEYS):
            raise ValueError(f"the step needs draws {DRAW_KEYS} or a generator")
        temp = self.nce_temp if nce_temp is None else nce_temp
        B = voxel.shape[0]
        if any(k not in d for k in DRAW_KEYS):
            tokens = style_target.reshape(B, -1, state.prior.net.dim).shape[1]
            d = step_draws(state, B * dp_size(self.mesh), generator, tokens)
            if self.mesh is not None:
                d = draw_rows(d, batch_sharding(self.mesh))
        clip_voxels, proj = state.brain(voxel, d["dropout"])
        loss_prior, _ = state.prior.loss(clip_voxels, style_target, d["times"], d["noise"],
                                         d["brain_keep"], d["image_keep"])
        proj_flat = proj.reshape(B, -1)
        target_norm, proj_norm = _unit(style_target), _unit(proj_flat)
        loss_nce = soft_clip_loss(dp_gather(proj_norm, self.mesh, grad=True),
                                  dp_gather(target_norm, self.mesh), temp=temp)
        loss = loss_nce + self.prior_loss_weight * loss_prior
        sims = batchwise_cosine_similarity(dp_gather(style_target, self.mesh),
                                           dp_gather(proj_flat.detach(), self.mesh))
        labels = torch.arange(sims.shape[0], device=voxel.device)
        return loss, {
            "loss": loss, "loss_nce": loss_nce, "loss_prior": loss_prior,
            "cosine_sim": (proj_norm * target_norm).sum(-1).mean(),
            "top1_fwd": topk_accuracy(sims, labels, k=1),
            "top1_bwd": topk_accuracy(sims.T, labels, k=1),
        }

    def train_step(self, state: PriorTrainState, voxel, style_target, nce_temp=None,
                   draws=None, generator=None) -> Dict[str, torch.Tensor]:
        """One clipped, scheduled AdamW step in place; ``state.step`` + 1."""
        state.optimizer.zero_grad()
        loss, metrics = self.loss_fn(state, voxel, style_target, nce_temp, draws, generator)
        loss.backward()
        reduce_gradients([p for g in state.optimizer.adamw.param_groups for p in g["params"]],
                         self.mesh)
        state.optimizer.step(state.step)
        state.step += 1
        return dp_mean({k: v.detach() for k, v in metrics.items()}, self.mesh)

    @torch.no_grad()
    def eval_step(self, state: PriorTrainState, voxel, style_target, nce_temp=None,
                  draws=None, generator=None) -> Dict[str, torch.Tensor]:
        """The step's metrics without an update (dropout and condition
        dropout act, as in JAX's eval step)."""
        return dp_mean(self.loss_fn(state, voxel, style_target, nce_temp, draws, generator)[1],
                       self.mesh)
