"""VOCASET-style vertex-animation dataset for the vertex-space FaceFormer
(port of ``avi_talking_tpu/data/vocaset.py``; host only).

Walks ``<root>/wav``, reads ``templates.pkl`` (the dataset's own pickle,
latin1) and the per-sentence vertex npys (VOCASET's 60 fps taken [::2]),
keeps the subjects and sentence ids of the split, and gives each item its
subject's one-hot among the training subjects. Audio is decoded by the
port's frontend and normalised Wav2Vec2Processor-style.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import List, Sequence

import numpy as np

from ..audio.frontend import normalize_audio, read_wav

VOCASET_SPLITS = {
    "vocaset": {"train": range(1, 41), "val": range(21, 41), "test": range(21, 41)},
    "BIWI": {"train": range(1, 33), "val": range(33, 37), "test": range(37, 41)},
}


@dataclasses.dataclass
class VocasetItem:
    name: str
    audio: np.ndarray  # (samples,) normalised float32
    vertice: np.ndarray  # (T, V*3)
    template: np.ndarray  # (V*3,)
    one_hot: np.ndarray  # (num_train_subjects,)


class VocasetDataset:
    def __init__(
        self,
        root: str,
        train_subjects: Sequence[str],
        val_subjects: Sequence[str],
        test_subjects: Sequence[str],
        wav_dir: str = "wav",
        vertices_dir: str = "vertices_npy",
        template_file: str = "templates.pkl",
        dataset_kind: str = "vocaset",
        split: str = "train",
    ):
        self.split = split
        self.train_subjects = list(train_subjects)
        subjects = {"train": list(train_subjects), "val": list(val_subjects),
                    "test": list(test_subjects)}[split]
        sentence_range = VOCASET_SPLITS[dataset_kind][split]
        with open(os.path.join(root, template_file), "rb") as f:
            templates = pickle.load(f, encoding="latin1")

        self.items: List[VocasetItem] = []
        vert_root = os.path.join(root, vertices_dir)
        eye = np.eye(len(self.train_subjects), dtype=np.float32)
        for r, _dirs, files in os.walk(os.path.join(root, wav_dir)):
            for f in sorted(files):
                if not f.endswith(".wav"):
                    continue
                key = f.replace("wav", "npy")
                subject = "_".join(key.split("_")[:-1])
                sentence = int(key.split(".")[0][-2:])
                if subject not in subjects or sentence not in sentence_range:
                    continue
                vpath = os.path.join(vert_root, key)
                if not os.path.exists(vpath):
                    continue
                wav, _sr = read_wav(os.path.join(r, f))
                verts = np.load(vpath, allow_pickle=True)
                if dataset_kind == "vocaset":
                    verts = verts[::2]  # 60 -> 30 fps
                one_hot = eye[self.train_subjects.index(subject)] \
                    if subject in self.train_subjects else eye[0]
                self.items.append(VocasetItem(
                    name=f,
                    audio=normalize_audio(wav[None]),
                    vertice=verts.astype(np.float32),
                    template=np.asarray(templates[subject]).reshape(-1).astype(np.float32),
                    one_hot=one_hot,
                ))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> VocasetItem:
        return self.items[i]
