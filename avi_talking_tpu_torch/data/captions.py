"""Instruction-caption datasets and MEAD filename parsing (a copy of
``avi_talking_tpu/data/captions.py``; host only, and the port imports
nothing of the JAX package).

``CaptionDataset`` reads the reference's test-fixture format
(experiments/json_dir/*.json):
``{"mm_paths": <wav path or dir>, "caption": [<instruction>, ...]}``.

``MeadFilenameParser``: MEAD clip names ``M012_front_neutral_level1_017`` ->
(identity, emotion, intensity) indices used to build the one-hot style
condition.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Iterator, List, Optional, Tuple

MEAD_TRAINING_IDS: Tuple[str, ...] = (
    "M003", "M005", "M007", "M009", "M011", "M012", "M013", "M019",
    "M022", "M023", "M024", "M025", "M026", "M027", "M028", "M029",
    "M030", "M031", "W009", "W011", "W014", "W015", "W016", "W018",
    "W019", "W021", "W023", "W024", "W025", "W026", "W028", "W029",
)

MEAD_EMOTIONS = {
    "neutral": 0, "happy": 1, "sad": 2, "surprised": 3, "fear": 4,
    "disgusted": 5, "angry": 6, "contempt": 7, "none": 8,
}


class MeadFilenameParser:
    def __init__(self, training_ids: Tuple[str, ...] = MEAD_TRAINING_IDS):
        self.training_ids = list(training_ids)

    def parse(self, fn: str) -> Tuple[int, int, int]:
        """'M012_front_neutral_level1_017' -> (id_idx, emo_idx, int_idx)."""
        base = os.path.basename(fn)
        base = base.split(".")[0]
        id_name, _, emotion, intensity, _ = base.split("_")
        return (
            self.training_ids.index(id_name),
            MEAD_EMOTIONS[emotion],
            int(intensity.replace("level", "")) - 1,
        )


@dataclasses.dataclass(frozen=True)
class CaptionItem:
    wav_path: str
    captions: Tuple[str, ...]
    name: str


class CaptionDataset:
    """Reads a directory of {mm_paths, caption} JSONs (+ optional wav dir
    with matching subfolders, like experiments/{json_dir,wav_dir})."""

    def __init__(self, json_dir: str, wav_dir: Optional[str] = None):
        self.items: List[CaptionItem] = []
        for jp in sorted(glob.glob(os.path.join(json_dir, "*.json"))):
            with open(jp) as f:
                meta = json.load(f)
            name = os.path.splitext(os.path.basename(jp))[0]
            wav = meta["mm_paths"]
            if not os.path.isabs(wav) or not os.path.exists(wav):
                # resolve against wav_dir/<json stem>/
                if wav_dir is not None:
                    cands = sorted(
                        glob.glob(os.path.join(wav_dir, name, "*.wav"))
                    ) or sorted(glob.glob(os.path.join(wav_dir, "*", "*.wav")))
                    if cands:
                        wav = cands[0]
            caps = meta["caption"]
            if isinstance(caps, str):
                caps = [caps]
            self.items.append(CaptionItem(wav, tuple(caps), name))

    def __len__(self) -> int:
        return len(self.items)

    def __iter__(self) -> Iterator[CaptionItem]:
        return iter(self.items)

    def __getitem__(self, i: int) -> CaptionItem:
        return self.items[i]
