"""DDPM noise schedule, diffusion-prior training loss and sampling (port of
``avi_talking_tpu/models/diffusion.py``): cosine beta schedule in float64
numpy, x0 prediction, image_embed_scale = sqrt(dim).

The training loss (``loss`` / ``p_losses``) takes its times, noise and
condition keep masks explicitly or draws them from a ``torch.Generator``.
Both samplers take their noise explicitly (``noise_init`` (B, n, D) and, for
DDPM, ``noise_steps`` (steps, B, n, D)), or draw it from the given
``torch.Generator`` on the text embedding's device: jax.random streams cannot
be reproduced in torch, so the tests hand both packages the same draws.
Schedule coefficients are read on the host as fp32 scalars, as the JAX
version gathers them from fp32 tables. Those tables promote a bfloat16
prediction to float32 before it meets them, so the samplers take the
network's prediction in float32 and carry x in float32 at any compute dtype.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .prior_transformer import PriorTransformerNetwork, l2norm


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

    @functools.cached_property
    def _q_tables(self) -> Dict[torch.device, torch.Tensor]:
        """fp32 (sqrt_alphas_cumprod, sqrt_one_minus_alphas_cumprod) rows
        by device, each copied there once: a copy from host memory waits
        for the card, and the training step samples every step."""
        return {}

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor
                 ) -> torch.Tensor:
        """x_t at the per-row timesteps ``t`` (B,), coefficients gathered
        from fp32 tables as in JAX."""
        tables = self._q_tables.get(x_start.device)
        if tables is None:
            rows = np.stack([self.sqrt_alphas_cumprod, self.sqrt_one_minus_alphas_cumprod])
            tables = torch.as_tensor(rows.astype(np.float32), device=x_start.device)
            self._q_tables[x_start.device] = tables
        coef = tables[:, t.long()].reshape((2,) + t.shape + (1,) * (x_start.dim() - 1))
        return coef[0] * x_start + coef[1] * noise

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
    text_cond_drop_prob: float = 0.2
    image_cond_drop_prob: float = 0.2
    training_clamp_l2norm: bool = False

    @property
    def embed_scale(self) -> float:
        """image_embed_scale = sqrt(dim): dalle2's p_sample_loop un-scales
        the sample by it (training targets were scaled by it)."""
        return self.net.dim ** 0.5

    def p_losses(self, image_embed: torch.Tensor, times: torch.Tensor, text_embed: torch.Tensor,
                 noise: Optional[torch.Tensor] = None, brain_keep: Optional[torch.Tensor] = None,
                 image_keep: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """MSE of the x0 prediction from x_t (``image_embed`` (B, n, D),
        already scaled) against ``image_embed``; -> (loss, prediction)."""
        if noise is None:
            noise = torch.randn(image_embed.shape, generator=generator, device=generator.device)
        noisy = self.scheduler.q_sample(image_embed, times, noise.to(image_embed.device))
        pred = self.net(noisy, times, text_embed,
                        brain_cond_drop_prob=self.text_cond_drop_prob,
                        image_cond_drop_prob=self.image_cond_drop_prob,
                        brain_keep=brain_keep, image_keep=image_keep, generator=generator)
        if self.training_clamp_l2norm:
            pred = l2norm(pred) * self.embed_scale
        return ((pred - image_embed) ** 2).mean(), pred  # the target is x_start

    def loss(self, text_embed: torch.Tensor, image_embed: torch.Tensor,
             times: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             brain_keep: Optional[torch.Tensor] = None, image_keep: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training loss at uniform random timesteps (``times`` (B,)
        when given) on the unscaled target ``image_embed`` (B, D) or
        (B, n, D)."""
        B = image_embed.shape[0]
        image_embed = image_embed.reshape(B, -1, self.net.dim)
        if times is None:
            times = torch.randint(0, self.scheduler.num_timesteps, (B,), generator=generator,
                                  device=generator.device)
        return self.p_losses(image_embed * self.embed_scale, times.to(image_embed.device),
                             text_embed, noise, brain_keep, image_keep, generator)

    def _predict_x_start(self, x, t: int, text_embed, cond_scale: float) -> torch.Tensor:
        tb = torch.full((x.shape[0],), t, dtype=torch.int32, device=x.device)
        return self.net.forward_with_cond_scale(x, tb, text_embed, cond_scale).float()

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
        eta: float = 0.0,
        noise_steps: Optional[torch.Tensor] = None,  # (steps, *shape), used when eta > 0
    ) -> torch.Tensor:
        """DDIM over a strided subset of timesteps: deterministic given the
        initial noise at ``eta = 0``; at ``eta > 0`` each step adds
        ``sigma * noise_steps[i]`` with JAX's
        ``sigma = eta * sqrt((1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev))``
        (float32)."""
        T = self.scheduler.num_timesteps
        times = np.linspace(-1, T - 1, steps + 1).astype(int)[::-1]
        acp = self.scheduler.alphas_cumprod.astype(np.float32)
        device = text_embed.device
        if noise_init is None:
            noise_init = torch.randn(shape, generator=generator, device=device)
        if eta > 0 and noise_steps is None:
            noise_steps = torch.randn((steps, *shape), generator=generator, device=device)
        x = noise_init.to(device)
        one, zero = np.float32(1.0), np.float32(0.0)
        for i, (t, t_prev) in enumerate(zip(times[:-1], times[1:])):
            x_start = self._predict_x_start(x, int(t), text_embed, cond_scale)
            a_t = acp[t]
            a_prev = acp[t_prev] if t_prev >= 0 else one
            eps = (x - float(np.sqrt(a_t)) * x_start) / float(np.sqrt(one - a_t))
            sigma = np.float32(eta) * np.sqrt((one - a_prev) / (one - a_t) * (one - a_t / a_prev))
            x = (float(np.sqrt(a_prev)) * x_start
                 + float(np.sqrt(np.maximum(one - a_prev - sigma * sigma, zero))) * eps)
            if eta > 0:
                x = x + float(sigma) * noise_steps[i].to(device)
        return x / self.embed_scale
