"""Coefficient normalisation statistics (a copy of
``avi_talking_tpu/data/stats.py``; host only).

The reference z-normalises the 53-d coefficients (50 exp + 3 jaw) with its
``coeff_mean`` / ``coeff_std`` arrays and pads the 6 pose / camera dims with
mean 0 and std 1; ``CoeffStats`` does the same, and can recompute the
statistics from data.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CoeffStats:
    mean: np.ndarray  # (D,)
    std: np.ndarray  # (D,)

    @classmethod
    def load(cls, mean_path: str, std_path: str, pad_extra: int = 0) -> "CoeffStats":
        mean = np.load(mean_path).astype(np.float32).reshape(-1)
        std = np.load(std_path).astype(np.float32).reshape(-1)
        if pad_extra > 0:
            mean = np.concatenate([mean, np.zeros(pad_extra, np.float32)])
            std = np.concatenate([std, np.ones(pad_extra, np.float32)])
        return cls(mean, std)

    @classmethod
    def from_data(cls, coeffs: np.ndarray, eps: float = 1e-6) -> "CoeffStats":
        """coeffs (N, D) -> per-dim stats (regenerates the missing
        coeff_*_Mead.npy assets from the dataset)."""
        flat = coeffs.reshape(-1, coeffs.shape[-1]).astype(np.float64)
        return cls(
            flat.mean(0).astype(np.float32),
            np.maximum(flat.std(0), eps).astype(np.float32),
        )

    @classmethod
    def identity(cls, dim: int) -> "CoeffStats":
        return cls(np.zeros(dim, np.float32), np.ones(dim, np.float32))

    def normalize(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean) / self.std

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        return x * self.std + self.mean

    def save(self, mean_path: str, std_path: str) -> None:
        np.save(mean_path, self.mean)
        np.save(std_path, self.std)
