"""DDPM noise schedule and diffusion-prior sampling (port of the sampling
half of ``avi_talking_tpu/models/diffusion.py``): cosine beta schedule in
float64 numpy, x0 prediction, image_embed_scale = sqrt(dim).

Both samplers take their noise explicitly (``noise_init`` (B, n, D) and, for
DDPM, ``noise_steps`` (steps, B, n, D)), or draw it from the given
``torch.Generator`` on the text embedding's device: jax.random streams cannot
be reproduced in torch, so the tests hand both packages the same draws.
Schedule coefficients are read on the host as fp32 scalars, as the JAX
version gathers them from fp32 tables.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .prior_transformer import PriorTransformerNetwork


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def _f32(x) -> np.float32:
    return np.float32(x)


@dataclasses.dataclass(frozen=True)
class NoiseScheduler:
    """Precomputed DDPM schedule (host numpy, float64)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    posterior_log_variance_clipped: np.ndarray

    @classmethod
    def create(cls, timesteps: int, beta_schedule: str = "cosine") -> "NoiseScheduler":
        if beta_schedule != "cosine":
            raise ValueError("only the cosine schedule is used by the reference")
        betas = cosine_beta_schedule(timesteps)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.concatenate([[1.0], acp[:-1]])
        posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
        return cls(
            betas=betas,
            alphas_cumprod=acp,
            alphas_cumprod_prev=acp_prev,
            sqrt_alphas_cumprod=np.sqrt(acp),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - acp),
            posterior_mean_coef1=betas * np.sqrt(acp_prev) / (1.0 - acp),
            posterior_mean_coef2=(1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp),
            posterior_log_variance_clipped=np.log(np.maximum(posterior_variance, 1e-20)),
        )

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    def q_posterior(self, x_start: torch.Tensor, x_t: torch.Tensor, t: int
                    ) -> Tuple[torch.Tensor, float]:
        """Posterior mean and log variance at the scalar timestep ``t``."""
        mean = (float(_f32(self.posterior_mean_coef1[t])) * x_start
                + float(_f32(self.posterior_mean_coef2[t])) * x_t)
        return mean, float(_f32(self.posterior_log_variance_clipped[t]))


@dataclasses.dataclass(frozen=True)
class DiffusionPrior:
    """Samples a 128-d style embedding conditioned on the brain network's
    CLIP-space embedding."""

    net: PriorTransformerNetwork
    scheduler: NoiseScheduler

    @property
    def embed_scale(self) -> float:
        """image_embed_scale = sqrt(dim): dalle2's p_sample_loop un-scales
        the sample by it (training targets were scaled by it)."""
        return self.net.dim ** 0.5

    def _predict_x_start(self, x, t: int, text_embed, cond_scale: float) -> torch.Tensor:
        tb = torch.full((x.shape[0],), t, dtype=torch.int32, device=x.device)
        return self.net.forward_with_cond_scale(x, tb, text_embed, cond_scale)

    def p_sample_loop(
        self,
        shape: Tuple[int, ...],  # (B, n, D)
        text_embed: torch.Tensor,
        cond_scale: float = 1.0,
        noise_init: Optional[torch.Tensor] = None,
        noise_steps: Optional[torch.Tensor] = None,  # (steps, B, n, D)
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Ancestral DDPM sampling over every timestep."""
        steps = self.scheduler.num_timesteps
        device = text_embed.device
        if noise_init is None:
            noise_init = torch.randn(shape, generator=generator, device=device)
        if noise_steps is None:
            noise_steps = torch.randn((steps, *shape), generator=generator, device=device)
        x = noise_init.to(device)
        noise_steps = noise_steps.to(device)
        for i in range(steps):
            t = steps - 1 - i
            x_start = self._predict_x_start(x, t, text_embed, cond_scale)
            mean, log_var = self.scheduler.q_posterior(x_start, x, t)
            if t > 0:
                x = mean + float(np.exp(_f32(0.5) * _f32(log_var))) * noise_steps[i]
            else:
                x = mean
        return x / self.embed_scale

    def ddim_sample_loop(
        self,
        shape: Tuple[int, ...],
        text_embed: torch.Tensor,
        steps: int = 20,
        cond_scale: float = 1.0,
        noise_init: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Deterministic DDIM (eta = 0) over a strided subset of timesteps."""
        T = self.scheduler.num_timesteps
        times = np.linspace(-1, T - 1, steps + 1).astype(int)[::-1]
        acp = self.scheduler.alphas_cumprod.astype(np.float32)
        if noise_init is None:
            noise_init = torch.randn(shape, generator=generator, device=text_embed.device)
        x = noise_init.to(text_embed.device)
        one = np.float32(1.0)
        for t, t_prev in zip(times[:-1], times[1:]):
            x_start = self._predict_x_start(x, int(t), text_embed, cond_scale)
            a_t = acp[t]
            a_prev = acp[t_prev] if t_prev >= 0 else one
            eps = (x - float(np.sqrt(a_t)) * x_start) / float(np.sqrt(one - a_t))
            x = (float(np.sqrt(a_prev)) * x_start
                 + float(np.sqrt(np.maximum(one - a_prev, np.float32(0.0)))) * eps)
        return x / self.embed_scale
