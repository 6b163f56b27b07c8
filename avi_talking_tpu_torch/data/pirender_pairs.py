"""PIRender video-pair training data (port of
``avi_talking_tpu/data/pirender_pairs.py``).

The reference's VoxDataset / VoxVideoDataset sampling: per sample, an
identity, one of its clips, a (source, target) frame pair of that clip
drawn with replacement, and the edge-clamped ``2 * radius + 1``-frame
coefficient window around the target (radius 13: the 27 frames MappingNet
reads). The source is an EMOCA-preprocessed MEAD root (``data.mead``:
detection crops and exp / pose / cam codes); the descriptor is the 59-d
``[exp50 | rot3 | jaw3 | cam3]``. ``cross_id`` draws the source image
from another identity's first frame (the cross-reenactment evaluation).

numpy throughout, from ``numpy.random.default_rng(seed)``, so the draws
are JAX's; images are (H, W, 3) in [-1, 1] and windows (27, 59), batched
NHWC and (B, 27, 59) as JAX's. A resize to ``image_size`` is
``jax.image.resize``'s bilinear (``ops.resize``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from .mead import MeadEmocaDataset


def obtain_seq_index(index: int, num_frames: int, radius: int) -> List[int]:
    """Edge-clamped window indices (vox_dataset.py)."""
    return [min(max(i, 0), num_frames - 1) for i in range(index - radius, index + radius + 1)]


@dataclasses.dataclass
class VideoPairDataset:
    """(source_image, target_image, target coeff window) training pairs from
    an EMOCA-preprocessed root."""

    root: str
    radius: int = 13  # semantic_radius
    cross_id: bool = False
    image_size: Optional[int] = None  # resize the crops (None: as they are)
    seed: int = 0

    def __post_init__(self):
        self.ds = MeadEmocaDataset(root=self.root, load_images=False)
        self._rng = np.random.default_rng(self.seed)
        self.clips = []
        for i, clip in enumerate(self.ds.index):
            paths = self.ds.image_paths(i)
            if len(paths) >= 2:
                self.clips.append({"index": i, "name": clip["name"],
                                   "person": os.path.basename(clip["name"]).split("_")[0],
                                   "images": paths})
        self.person_ids = sorted({c["person"] for c in self.clips})
        self._by_person: Dict[str, List[int]] = {}
        for k, c in enumerate(self.clips):
            self._by_person.setdefault(c["person"], []).append(k)
        self._sem_cache: Dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.clips)

    def _semantics(self, k: int) -> np.ndarray:
        """(T, 59) raw [exp | rot | jaw | cam] descriptors of clip k."""
        if k not in self._sem_cache:
            codes = self.ds._load_codes(self.ds.index[self.clips[k]["index"]]["frames"])
            exp = codes["exp"][:, :50]
            if exp.shape[1] < 50:
                exp = np.pad(exp, ((0, 0), (0, 50 - exp.shape[1])))
            self._sem_cache[k] = np.concatenate(
                [exp, codes["pose"][:, :3], codes["pose"][:, 3:6], codes["cam"][:, :3]],
                axis=-1).astype(np.float32)
        return self._sem_cache[k]

    def _image(self, k: int, t: int) -> np.ndarray:
        from ..ops.resize import resize_image_hwc
        from ..viz.pngio import read_image_normalized

        paths = self.clips[k]["images"]
        img = read_image_normalized(paths[min(t, len(paths) - 1)])
        if self.image_size and img.shape[0] != self.image_size:
            img = resize_image_hwc(img, self.image_size)
        return img

    def _window(self, k: int, t: int) -> np.ndarray:
        sem = self._semantics(k)
        return sem[obtain_seq_index(t, sem.shape[0], self.radius)]  # (2r+1, 59)

    def sample(self) -> Dict[str, np.ndarray]:
        """One training pair (VoxDataset.__getitem__)."""
        person = self.person_ids[self._rng.integers(0, len(self.person_ids))]
        k = self._by_person[person][self._rng.integers(0, len(self._by_person[person]))]
        T = min(len(self.clips[k]["images"]), self._semantics(k).shape[0])
        # with replacement (s may be t), as the reference's random.choices
        s, t = self._rng.integers(0, T, size=2)
        if self.cross_id and len(self.person_ids) > 1:
            other = person
            while other == person:
                other = self.person_ids[self._rng.integers(0, len(self.person_ids))]
            ks = self._by_person[other][self._rng.integers(0, len(self._by_person[other]))]
            # the other identity's first frame, with that frame's semantics
            src_img, src_sem = self._image(ks, 0), self._window(ks, 0)
        else:
            src_img, src_sem = self._image(k, int(s)), self._window(k, int(s))
        return {"input_image": src_img, "target_image": self._image(k, int(t)),
                "coeff_window": self._window(k, int(t)), "source_semantics": src_sem}

    def batches(self, batch_size: int,
                epochs: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        """Batches in the trainer's keys (images NHWC, windows (B, 27, C));
        an epoch is 100 samples per identity, as the reference's x100."""
        per_epoch = max(1, 100 * len(self.person_ids) // max(batch_size, 1))
        e = 0
        while epochs is None or e < epochs:
            for _ in range(per_epoch):
                samples = [self.sample() for _ in range(batch_size)]
                yield {key: np.stack([s[key] for s in samples]) for key in samples[0]}
            e += 1
