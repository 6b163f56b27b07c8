"""FLINT motion prior: encoder, Gaussian VAE and VQ-VAE for training (port
of ``avi_talking_tpu/models/flint_vae.py``).

The reference's ``L2lVqVae`` encoder half:

* squasher: ``Conv1d(k5, s2)`` on a two-frame replicate pad, then (q-1) x
  [replicate-padded ``Conv1d(k5)``, max-pool 2], each stage LeakyReLU(0.2) +
  BatchNorm -> T / 2^q latent frames;
* linear embedding -> positional encoding -> post-LN transformer encoder
  (the plain attention path, as JAX's encoder layers);
* ``FlintVAE``: mean / log-variance heads and the reparameterised sample;
  loss = reconstruction MSE + ``kl_weight`` x KL;
* ``FlintVQVAE``: ``VectorQuantizer`` (nearest codebook vector,
  straight-through estimator); loss = reconstruction + codebook commitment
  + ``beta`` x encoder alignment.

Parameter names follow ``L2lVqVae`` (``squasher.{i}.0`` conv,
``squasher.{i}.2`` BatchNorm, ``expander.*`` in the decoder). Every
BatchNorm is ``models.flint.FlaxBatchNorm1d``: ``module.train()`` normalises
by the batch and updates the running statistics by flax's rule, as JAX's
``train=True`` with ``mutable=["batch_stats"]``; ``eval()`` reads them.
The random draws are arguments (the VAE's ``noise``, the Gumbel
quantizer's ``u``), so a caller can feed JAX's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.layers import Conv1d, LeakyReLU, Linear
from ..ops.positional import periodic_positional_encoding, sinusoidal_positional_encoding
from ..ops.transformer import TransformerEncoder
from .flint import FlaxBatchNorm1d, FlintConfig, FlintDecoder


def _perplexity(idx: torch.Tensor, codebook_size: int) -> torch.Tensor:
    """exp of the entropy of the codes' histogram."""
    e_mean = torch.nn.functional.one_hot(idx, codebook_size).float().mean(0)
    return torch.exp(-torch.sum(e_mean * torch.log(e_mean + 1e-10)))


class FlintEncoder(nn.Module):
    """(B, T, in_dim) motion -> (B, T / 2^q, feature_dim) latent features."""

    def __init__(self, cfg: FlintConfig, in_dim: int = 53):
        super().__init__()
        c = self.cfg = cfg
        f = c.feature_dim
        stages = [nn.Sequential(
            Conv1d(in_dim, f, 5, stride=2, padding=2, padding_mode="replicate"),
            LeakyReLU(0.2),
            FlaxBatchNorm1d(f, eps=1e-5),
        )]
        for _ in range(1, c.quant_factor):
            stages.append(nn.Sequential(
                Conv1d(f, f, 5, padding=2, padding_mode="replicate"),
                LeakyReLU(0.2),
                FlaxBatchNorm1d(f, eps=1e-5),
                nn.MaxPool1d(2),
            ))
        self.squasher = nn.ModuleList(stages)
        self.encoder_linear_embedding = Linear(f, f)
        self.encoder_transformer = TransformerEncoder(
            c.num_layers, f, c.nhead, c.intermediate_size, c.activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        h = x.transpose(1, 2)
        for stage in self.squasher:
            h = stage(h)
        h = self.encoder_linear_embedding(h.transpose(1, 2))
        T = h.shape[1]
        if c.positional_encoding == "sinusoidal":
            h = h + sinusoidal_positional_encoding(T, c.feature_dim, h.dtype, h.device)[None]
        elif c.positional_encoding == "periodic":
            h = h + periodic_positional_encoding(
                T, c.feature_dim, c.pe_period, h.dtype, h.device)[None]
        return self.encoder_transformer(h)


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


class FlintVAE(nn.Module):
    """Gaussian temporal VAE over exp + jaw sequences (``L2lVqVae``, VAE
    mode)."""

    def __init__(self, cfg: FlintConfig):
        super().__init__()
        self.cfg = cfg
        f = cfg.feature_dim
        self.encoder = FlintEncoder(cfg, in_dim=cfg.out_dim)
        self.mean = Linear(f, f)
        self.logvar = Linear(f, f)
        self.decoder = FlintDecoder(cfg, batch_stats=True)

    def latent_shape(self, motion_shape) -> Tuple[int, int, int]:
        """The shape of ``noise`` for a (B, T, out_dim) motion batch."""
        B, T = motion_shape[:2]
        return B, T // self.cfg.latent_frame_size, self.cfg.feature_dim

    def encode(self, motion: torch.Tensor):
        feats = self.encoder(motion)
        return self.mean(feats), self.logvar(feats)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return self.decoder(latents)

    def forward(self, motion: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``motion`` (B, T, out_dim), T a multiple of 2^q; with ``noise``
        (``latent_shape``) z = mu + exp(logvar / 2) * noise, else z = mu."""
        mu, logvar = self.encode(motion)
        z = mu if noise is None else mu + torch.exp(0.5 * logvar) * noise
        return {"reconstruction": self.decode(z), "mu": mu, "logvar": logvar, "z": z}

    def loss(self, motion: torch.Tensor, noise: Optional[torch.Tensor],
             kl_weight: float = 0.01) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        out = self(motion, noise)
        recon = _mse(out["reconstruction"], motion)
        kl = -0.5 * torch.mean(1 + out["logvar"] - out["mu"] ** 2 - torch.exp(out["logvar"]))
        loss = recon + kl_weight * kl
        return loss, {"loss": loss, "recon": recon, "kl": kl}


class _Codebook(nn.Module):
    """A (codebook_size, vector_dim) ``embedding`` whose seeded init is
    uniform in [-1/K, 1/K), as JAX's."""

    def __init__(self, codebook_size: int, vector_dim: int):
        super().__init__()
        self.codebook_size, self.vector_dim = codebook_size, vector_dim
        self.embedding = nn.Parameter(torch.empty(codebook_size, vector_dim))
        self.uniform_init = {"embedding": (-1.0 / codebook_size, 1.0 / codebook_size)}


class VectorQuantizer(_Codebook):
    """VQ-VAE bottleneck over (B, T, D) features: nearest codebook vector,
    straight-through gradients, the alignment ``||sg[z_q] - z||^2`` and
    commitment ``||z_q - sg[z]||^2`` terms, and the codes' perplexity."""

    def forward(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        emb = self.embedding
        flat = z.reshape(-1, self.vector_dim)
        d = (torch.sum(flat ** 2, dim=1, keepdim=True) + torch.sum(emb ** 2, dim=1)[None]
             - 2.0 * flat @ emb.T)
        idx = torch.argmin(d, dim=1)
        z_q = emb[idx].reshape(z.shape).to(z.dtype)
        return {
            "quantized": z + (z_q - z).detach(),  # straight-through
            "codes": idx.reshape(z.shape[:-1]),
            "alignment": _mse(z_q.detach(), z),
            "commitment": _mse(z_q, z.detach()),
            "perplexity": _perplexity(idx, self.codebook_size),
        }


class GumbelVectorQuantizer(_Codebook):
    """Gumbel-softmax quantizer: the (B, T, K) input is read as logits over
    the codebook; ``softmax((logits + g) / tau)`` with Gumbel noise
    ``g = -log(-log(u))`` when ``u`` (uniform in [1e-10, 1), the logits'
    shape) is given; z_q the soft assignments' mix of codebook vectors;
    KL(uniform || assignments); the perplexity of the argmax codes (JAX's
    choice over the reference's never-filled buffer)."""

    def forward(self, logits: torch.Tensor, u: Optional[torch.Tensor] = None,
                tau: float = 1.0) -> Dict[str, torch.Tensor]:
        B, T = logits.shape[:2]
        flat = logits.reshape(B * T, -1)
        if u is not None:
            flat = flat + (-torch.log(-torch.log(u.reshape(flat.shape))))
        soft = torch.softmax(flat / tau, dim=-1)
        z_q = (soft @ self.embedding).reshape(B, T, self.vector_dim).to(logits.dtype)
        uniform = 1.0 / self.codebook_size
        log_uniform = torch.log(soft.new_tensor(uniform + 1e-10))  # in the logits' dtype, as JAX's
        kl = torch.mean(torch.sum(uniform * (log_uniform - torch.log(soft + 1e-10)), dim=1))
        idx = torch.argmax(soft, dim=-1)
        return {"quantized": z_q, "soft_assignments": soft, "codes": idx.reshape(B, T),
                "kl_divergence": kl, "perplexity": _perplexity(idx, self.codebook_size)}

    @staticmethod
    def codebook_entry(emb: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        """Indices -> codebook vectors."""
        return emb[indices]


class FlintVQVAE(nn.Module):
    """VQ mode of the motion prior: encoder -> ``VectorQuantizer`` ->
    decoder; loss = recon + commitment + ``beta`` x alignment."""

    def __init__(self, cfg: FlintConfig, codebook_size: int = 256, beta: float = 0.25):
        super().__init__()
        self.cfg, self.beta = cfg, beta
        self.encoder = FlintEncoder(cfg, in_dim=cfg.out_dim)
        self.quantizer = VectorQuantizer(codebook_size, cfg.feature_dim)
        self.decoder = FlintDecoder(cfg, batch_stats=True)

    def encode(self, motion: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.quantizer(self.encoder(motion))

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return self.decoder(latents)

    def forward(self, motion: torch.Tensor) -> Dict[str, torch.Tensor]:
        q = self.encode(motion)
        return {"reconstruction": self.decode(q["quantized"]), **q}

    def loss(self, motion: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        out = self(motion)
        recon = _mse(out["reconstruction"], motion)
        loss = recon + out["commitment"] + self.beta * out["alignment"]
        return loss, {"loss": loss, "recon": recon, "alignment": out["alignment"],
                      "commitment": out["commitment"], "perplexity": out["perplexity"]}
