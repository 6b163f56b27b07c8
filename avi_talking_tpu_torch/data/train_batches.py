"""Real-data training batches for EMOTE and the stage-1 FaceFormers (port
of ``avi_talking_tpu/data/train_batches.py``).

* ``EmoteBatchBuilder`` / ``emote_batches``: MEAD items -> the EMOTE
  trainer's batch (framed audio, denormalised gt exp / jaw, one-hot style
  conditions, shape, frame mask), with a clip-level train / val ``split``;
* ``FaceFormerBatchBuilder``: MEAD items -> stage-1 FaceFormer items, with
  the detection crops where asked;
* ``FanConditioner``: the stage-1 conditioning the reference computes per
  batch with a frozen FanEncoder (its ``models/faceformer.py:334-373``):
  eye embeddings from the raw crops, emotion embeddings from lip-masked
  frames shuffled in time, and the coefficients at one random frame.

The builders are host numpy and draw from ``np.random.default_rng`` in the
JAX package's order, so both packages give the same batches; the
conditioner's two FAN passes run in torch on the FAN's device.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .captions import MeadFilenameParser
from .mead import MeadEmocaDataset


@dataclasses.dataclass
class EmoteBatchBuilder:
    """Indexable view over a MEAD root yielding fixed-shape items
    (stackable by ``batching.default_collate``), all float32:

      raw_audio  (frames, 640)    16 kHz audio framed at 25 fps
      gt_exp     (frames, n_exp)  denormalised FLAME expression
      gt_jaw     (frames, 3)      denormalised jaw pose
      expression (n_expressions,) one-hot  \
      intensity  (n_intensities,) one-hot   > the MEAD name's conditions
      identity   (n_identities,)  one-hot  /
      shape      (n_shape,)       the window's first EMOCA shape code, cut or
                                  zero-padded to n_shape (also ``gt_shape``)
      frame_mask (frames,)        1 for real frames, 0 for padding

    Clips without a wav or with a name that does not parse are left out.
    """

    ds: MeadEmocaDataset
    frames: int
    n_exp: int = 50
    n_shape: int = 300
    n_expressions: int = 9
    n_intensities: int = 3
    n_identities: int = 32

    def __post_init__(self):
        parser = MeadFilenameParser()
        self.valid: List[int] = []
        for i, clip in enumerate(self.ds.index):
            if not clip.get("wav"):
                continue
            try:
                parser.parse(os.path.basename(clip["name"]))
            except (ValueError, KeyError, IndexError):
                continue
            self.valid.append(i)
        self.ds.seq_length = self.frames

    def __len__(self) -> int:
        return len(self.valid)

    def split(self, val_fraction: float,
              seed: int = 0) -> Tuple["EmoteBatchBuilder", "EmoteBatchBuilder"]:
        """A deterministic clip-level (train, val) split: names ordered by
        crc32, ``round(val_fraction * n)`` of them to val (at least 1 and at
        most n - 1 where the fraction is nonzero and n >= 2). The val side's
        dataset takes leading windows and first captions."""
        names = [self.ds.index[i]["name"] for i in self.valid]
        order = sorted(range(len(names)),
                       key=lambda k: zlib.crc32(f"{seed}:{names[k]}".encode()))
        n_val = int(round(val_fraction * len(order)))
        if val_fraction > 0 and len(order) >= 2:
            n_val = min(max(n_val, 1), len(order) - 1)
        val_set = set(order[:n_val])
        tr = copy.copy(self)
        va = copy.copy(self)
        tr.valid = [v for k, v in enumerate(self.valid) if k not in val_set]
        va.valid = [v for k, v in enumerate(self.valid) if k in val_set]
        va.ds = copy.copy(self.ds)
        va.ds.split = "val"
        return tr, va

    @staticmethod
    def _fit(x: np.ndarray, width: int) -> np.ndarray:
        if x.shape[-1] >= width:
            return x[..., :width]
        return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, width - x.shape[-1])])

    def __getitem__(self, k: int) -> Dict[str, np.ndarray]:
        item = self.ds[self.valid[k]]
        T = self.frames
        coeff = self.ds.stats.denormalize(item["coeff"])  # (L, E + 9) raw
        L = coeff.shape[0]
        E = coeff.shape[-1] - 9  # [exp(E), jaw 3, global rotation 3, cam 3]
        gt_exp = np.zeros((T, self.n_exp), np.float32)
        gt_exp[:L] = self._fit(coeff[:, :E], self.n_exp)
        gt_jaw = np.zeros((T, 3), np.float32)
        gt_jaw[:L] = coeff[:, E:E + 3]
        audio = np.zeros((T, 640), np.float32)
        audio[:L] = np.asarray(item["audio"], np.float32).reshape(-1, 640)[:L]
        mask = np.zeros((T,), np.float32)
        mask[:L] = 1.0

        def onehot(idx, n):
            v = np.zeros((n,), np.float32)
            v[int(idx)] = 1.0
            return v

        shape = self._fit(np.asarray(item["shape"][0], np.float32), self.n_shape)
        return {
            "raw_audio": audio,
            "gt_exp": gt_exp,
            "gt_jaw": gt_jaw,
            "expression": onehot(item["emotion_idx"], self.n_expressions),
            "intensity": onehot(item["intensity_idx"], self.n_intensities),
            "identity": onehot(item["identity_idx"], self.n_identities),
            "shape": shape,
            "gt_shape": shape,
            "frame_mask": mask,
        }


def emote_batches(builder: EmoteBatchBuilder, batch_size: int, shuffle: bool = True,
                  seed: int = 0, epochs: Optional[int] = None):
    """Stacked numpy batches, endless with ``epochs=None``; the last short
    batch of an epoch is dropped."""
    from .batching import batch_iterator

    return batch_iterator(builder, batch_size, shuffle=shuffle, seed=seed, drop_last=True,
                          epochs=epochs)


@dataclasses.dataclass
class FaceFormerBatchBuilder:
    """MEAD root -> stage-1 FaceFormer items, stackable by
    ``batching.default_collate``:

      audio      (frames*640,)       flat 16 kHz samples
      coeff      (frames, coeff_dim) NORMALISED coefficients, edge-padded
      frame_mask (frames,)
      pose       (frames, 6)         raw EMOCA pose (global rotation + jaw)
      cam        (frames, 3)         raw EMOCA camera
      emo_idx    ()                  MEAD emotion label in ``train.emo_cls.EMO2IDX``
                                     order, -1 where the name has none
      img        (frames, H, W, 3)   detection crops in [-1, 1], with
                                     ``load_images`` where the clip has them
      ref_img    (frames, H, W, 3)   the neutral reference's crops, likewise

    Clips without a wav are left out. Short windows repeat their last crop.
    """

    ds: MeadEmocaDataset
    frames: int
    coeff_dim: int = 53
    load_images: bool = True

    def __post_init__(self):
        self.valid = [i for i, clip in enumerate(self.ds.index) if clip.get("wav")]
        self.ds.seq_length = self.frames
        self.ds.load_images = self.load_images

    def __len__(self) -> int:
        return len(self.valid)

    def __getitem__(self, k: int) -> Dict[str, np.ndarray]:
        from ..train.emo_cls import EMO2IDX

        item = self.ds[self.valid[k]]
        T = self.frames
        coeff = np.asarray(item["coeff"], np.float32)[:, :self.coeff_dim]
        L = coeff.shape[0]
        c = np.zeros((T, coeff.shape[1]), np.float32)
        c[:L] = coeff
        if L < T:
            c[L:] = coeff[-1]  # edge pad: teacher forcing sees no jump to zero
        audio = np.zeros((T * 640,), np.float32)
        a = np.asarray(item["audio"], np.float32).reshape(-1)
        audio[:min(a.shape[0], T * 640)] = a[:T * 640]
        mask = np.zeros((T,), np.float32)
        mask[:L] = 1.0
        parts = self.ds.index[self.valid[k]].get("name", "").split("_")
        out: Dict[str, np.ndarray] = {
            "coeff": c, "audio": audio, "frame_mask": mask,
            "emo_idx": np.int32(EMO2IDX.get(parts[2], -1) if len(parts) > 2 else -1),
        }
        for key in ("pose", "cam"):
            v = np.asarray(item[key], np.float32)
            padded = np.zeros((T, v.shape[1]), np.float32)
            padded[:v.shape[0]] = v[:T]
            if v.shape[0] < T:
                padded[v.shape[0]:] = v[-1]
            out[key] = padded
        for key in ("img", "ref_img"):
            if key in item:
                img = np.asarray(item[key], np.float32)
                if img.shape[0] < T:
                    img = np.concatenate([img, np.repeat(img[-1:], T - img.shape[0], axis=0)])
                out[key] = img[:T]
        return out


@dataclasses.dataclass
class FanConditioner:
    """The frozen FanEncoder's stage-1 conditioning.

    ``condition(img, coeff)`` with img (B, T, H, W, 3) float32 crops in
    [-1, 1] and coeff (B, T, C) normalised coefficients (numpy) returns, on
    the FAN's device:

      eye_embed (B, T, eye_dim)  the eye head on the raw crops
      emo_embed (B, T, emo_dim)  the emotion head on lip-masked (``mask_lip``,
                                 ``mask_variant``) frames taken at i + offset,
                                 offset ~ U[4, 8), i - offset past the end
      ref_coeff (B, 1, C)        the coefficients at one random frame, the same
                                 for the whole batch

    The draws come from ``np.random.default_rng(seed)`` in the JAX
    package's order: B rows of offsets, then the reference frame. Both FAN
    passes run over the B * T crops at once, in eval mode, without a graph.
    """

    fan: torch.nn.Module  # models.fan_encoder.FanEncoder
    seed: int = 0
    mask_variant: str = "coeff"

    def __post_init__(self):
        self.fan.eval()
        self._rng = np.random.default_rng(self.seed)

    def shuffle_indices(self, T: int) -> np.ndarray:
        """j = i + off where that is in range, else i - off, off ~ U[4, 8)
        (the reference's ``models/faceformer.py:346-348``)."""
        off = self._rng.integers(4, 8, size=T)
        i = np.arange(T)
        return np.clip(np.where(i + off < T, i + off, i - off), 0, T - 1)

    def condition(self, img: np.ndarray, coeff: np.ndarray) -> Dict[str, torch.Tensor]:
        from ..models.fan_encoder import mask_lip

        B, T = img.shape[:2]
        sh = np.stack([self.shuffle_indices(T) for _ in range(B)])  # (B, T)
        device = next(self.fan.parameters()).device
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(device)
        shuffled = x[torch.arange(B, device=device)[:, None], torch.from_numpy(sh).to(device)]

        def nchw(t):
            return t.reshape(B * T, *t.shape[2:]).permute(0, 3, 1, 2).contiguous()

        with torch.no_grad():
            eye = self.fan(nchw(x))[1]
            emo = self.fan(mask_lip(nchw(shuffled), self.mask_variant))[2]
        ref_idx = int(self._rng.integers(0, T))
        return {
            "eye_embed": eye.reshape(B, T, -1),
            "emo_embed": emo.reshape(B, T, -1),
            "ref_coeff": torch.from_numpy(
                np.ascontiguousarray(coeff[:, ref_idx:ref_idx + 1], np.float32)).to(device),
        }
