"""Evaluation utilities: style diversity, vertex error, condition exchange
(port of ``avi_talking_tpu/train/eval_metrics.py``).

``condition_exchange`` doubles an EMOTE batch with the style conditions
exchanged across a derangement: the first half keeps its own conditions,
the second half borrows another sample's. The permutation is passed in
(a test hands in JAX's, since jax.random streams cannot be reproduced in
torch) or drawn from a ``torch.Generator`` by JAX's construction.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

CONDITION_KEYS = ("expression", "intensity", "identity")


def style_diversity(style_embs: torch.Tensor) -> torch.Tensor:
    """(N, D) sampled style embeddings -> mean pairwise L2 distance."""
    d = style_embs[:, None] - style_embs[None]
    dist = torch.sqrt((d ** 2).sum(-1) + 1e-12)
    n = style_embs.shape[0]
    mask = 1.0 - torch.eye(n, dtype=style_embs.dtype, device=style_embs.device)
    return (dist * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def vertex_l2(pred_vertices: torch.Tensor, gt_vertices: torch.Tensor) -> torch.Tensor:
    """(..., V, 3) -> scalar mean per-vertex euclidean error."""
    return torch.sqrt(((pred_vertices - gt_vertices) ** 2).sum(-1)).mean()


def lip_vertex_error(pred_vertices: torch.Tensor, gt_vertices: torch.Tensor,
                     mouth_mask: torch.Tensor) -> torch.Tensor:
    """LVE-style metric: max per-frame lip vertex error, averaged over time."""
    err = torch.sqrt(((pred_vertices - gt_vertices) ** 2).sum(-1))  # (..., V)
    return torch.where(mouth_mask, err, torch.zeros_like(err)).amax(dim=-1).mean()


def derangement(B: int, generator: torch.Generator) -> torch.Tensor:
    """JAX's construction: q∘roll(shift)∘q⁻¹ for a random permutation q and
    a shift in [1, max(B, 2)), which has no fixed point for B >= 2."""
    dev = generator.device
    q = torch.randperm(B, generator=generator, device=dev)
    shift = int(torch.randint(1, max(B, 2), (), generator=generator, device=dev))
    rolled = (torch.arange(B, device=dev) + shift) % B
    perm = torch.empty_like(q)
    perm[q] = q[rolled]
    return perm


def condition_exchange(
    batch: Dict[str, torch.Tensor],
    perm: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    condition_keys: Tuple[str, ...] = CONDITION_KEYS,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """-> (doubled batch, the permutation of the exchanged half). Takes
    ``perm`` when given, else draws ``derangement`` from ``generator``."""
    B = next(iter(batch.values())).shape[0]
    if perm is None:
        if generator is None:
            raise ValueError("condition_exchange needs perm or a generator")
        perm = derangement(B, generator)
    out: Dict[str, torch.Tensor] = {}
    for k, v in batch.items():
        other = v[perm.to(v.device)] if k in condition_keys else v
        out[k] = torch.cat([v, other], dim=0)
    return out, perm
