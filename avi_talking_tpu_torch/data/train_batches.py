"""Real-data batches for the stage-1 FaceFormers (port of
``FaceFormerBatchBuilder`` from ``avi_talking_tpu/data/train_batches.py``;
host only, numpy). ``EmoteBatchBuilder`` and ``FanConditioner`` are not
ported yet (ROADMAP Queue 1, item 2)."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .mead import MeadEmocaDataset


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

    Clips without a wav are left out. ``load_images`` (the detection crops)
    is passed to the dataset, which refuses it: its PNG reader is not ported.
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
        return out
