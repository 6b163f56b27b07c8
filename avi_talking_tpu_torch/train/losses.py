"""Training losses and retrieval metrics of the diffusion prior (port of
``avi_talking_tpu/train/losses.py``)."""

from __future__ import annotations

import math

import torch


def soft_clip_loss(preds: torch.Tensor, targs: torch.Tensor, temp: float = 0.125) -> torch.Tensor:
    """Bidirectional soft-target InfoNCE between projected text embeddings
    and style embeddings (both (B, D), expected pre-normalised)."""
    clip_clip = (targs @ targs.T) / temp
    brain_clip = (preds @ targs.T) / temp
    soft_targets = torch.softmax(clip_clip, dim=-1)
    loss1 = -(torch.log_softmax(brain_clip, dim=-1) * soft_targets).sum(-1).mean()
    loss2 = -(torch.log_softmax(brain_clip.T, dim=-1) * soft_targets).sum(-1).mean()
    return (loss1 + loss2) / 2


def cosine_anneal(start: float, end: float, steps: int) -> torch.Tensor:
    """(steps,) float32: ``start`` at 0 to ``end`` at steps - 1, by a half
    cosine."""
    t = torch.arange(steps, dtype=torch.float32)
    return end + (start - end) / 2 * (1 + torch.cos(math.pi * t / (steps - 1)))


def batchwise_cosine_similarity(Z: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(n, d) x (b, d) -> (b, n) cosine similarity (the reference's layout)."""
    Bt = B.T
    z_norm = torch.linalg.norm(Z, dim=1, keepdim=True)
    b_norm = torch.linalg.norm(Bt, dim=0, keepdim=True)
    return ((Z @ Bt) / (z_norm @ b_norm)).T


def topk_accuracy(similarities: torch.Tensor, labels: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Sum over the top-i hit rates, i in [1..k] (the reference's ``topk``)."""
    k = min(k, similarities.shape[0])
    order = torch.argsort(similarities, dim=1, stable=True)
    top = similarities.new_zeros(())
    for i in range(k):
        top = top + (order[:, -(i + 1)] == labels).float().mean()
    return top
