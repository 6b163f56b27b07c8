"""Offline instruction-caption generation (a copy of
``avi_talking_tpu/data/caption_gen.py``; host only).

The reference attaches a natural-language instruction to each MEAD clip
through ``talkclip_text_generation.text_gen.TalkClipDatabase`` (its
``dataset/data_loader.py:21,144-145,273-275``), a package that is not in
the reference repo. ``TalkClipGenerator`` rebuilds the capability
without any network: an EMFACS emotion->AU table and seeded template
realisation produce captions in the style of the fixture corpus
(``experiments/json_dir``: "A disappointed person speaks with fairly lifted
cheek, brow quite lowered, slightly lifted inner brow, and lip mildly
stretched."). The same clip name and seed give the same caption in both
packages.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# FACS action units -> short surface forms (standard AU glossary)
AU_PHRASES: Dict[int, str] = {
    1: "lifted inner brow",
    2: "raised outer brow",
    4: "lowered brow",
    5: "raised upper lid",
    6: "lifted cheek",
    7: "tightened lid",
    9: "wrinkled nose",
    10: "raised upper lip",
    12: "pulled lip corner",
    14: "dimpled cheek",
    15: "lowered lip corner",
    17: "raised chin",
    20: "stretched lip",
    23: "tightened lip",
    25: "parted lips",
    26: "dropped jaw",
}

# EMFACS-style prototypes: MEAD emotion -> characteristic AUs
EMOTION_AUS: Dict[str, Tuple[int, ...]] = {
    "neutral": (),
    "happy": (6, 12, 25),
    "sad": (1, 4, 15, 17),
    "surprised": (1, 2, 5, 26),
    "fear": (1, 2, 4, 5, 20, 26),
    "disgusted": (9, 15, 10),
    "angry": (4, 5, 7, 23),
    "contempt": (12, 14),
}

EMOTION_ADJECTIVES: Dict[str, Tuple[str, ...]] = {
    "neutral": ("calm", "neutral", "composed"),
    "happy": ("happy", "joyful", "cheerful", "delighted"),
    "sad": ("sad", "sorrowful", "disappointed", "downcast"),
    "surprised": ("surprised", "astonished", "startled"),
    "fear": ("fearful", "frightened", "anxious"),
    "disgusted": ("disgusted", "repulsed"),
    "angry": ("angry", "furious", "irritated"),
    "contempt": ("contemptuous", "scornful", "disdainful"),
}

# MEAD intensity level (1..3) -> adverb pool
INTENSITY_ADVERBS: Dict[int, Tuple[str, ...]] = {
    1: ("slightly", "mildly", "faintly"),
    2: ("fairly", "quite", "noticeably"),
    3: ("strongly", "intensely", "markedly"),
}


@dataclasses.dataclass
class TalkClipGenerator:
    """Seeded caption realiser: ``query(clip_name)`` -> instruction string.

    Deterministic per (clip name, seed): the same clip always gets the same
    caption within a generator — matching the reference's cached database
    behaviour — while different seeds give caption diversity for
    augmentation.
    """

    seed: int = 0
    max_aus: int = 4

    def caption(self, emotion: str, intensity: int, key: str = "") -> str:
        # crc32, not str hash: Python salts str hashing per process
        rng = np.random.default_rng(
            (self.seed, zlib.crc32(key.encode("utf-8")), intensity)
        )
        adjs = EMOTION_ADJECTIVES.get(emotion, (emotion,))
        adj = adjs[int(rng.integers(0, len(adjs)))]
        aus = list(EMOTION_AUS.get(emotion, ()))
        if not aus:
            return f"A {adj} person speaks with a relaxed, even expression."
        rng.shuffle(aus)
        aus = aus[: self.max_aus]
        level = int(np.clip(intensity, 1, 3))
        parts: List[str] = []
        for au in aus:
            pool = INTENSITY_ADVERBS[level]
            adv = pool[int(rng.integers(0, len(pool)))]
            phrase = AU_PHRASES[au]
            # vary adverb placement like the fixture corpus ("brow quite
            # lowered" vs "fairly lifted cheek")
            if rng.integers(0, 2) and " " in phrase:
                verb, noun = phrase.split(" ", 1)
                parts.append(f"{noun} {adv} {verb}")
            else:
                parts.append(f"{adv} {phrase}")
        if len(parts) > 1:
            body = ", ".join(parts[:-1]) + f", and {parts[-1]}"
        else:
            body = parts[0]
        return f"A {adj} person speaks with {body}."

    def query(self, clip_name: str) -> str:
        """MEAD clip name ('M003_front_happy_level2_001') -> caption
        (the TalkClipDatabase.query surface, data_loader.py:275)."""
        base = os.path.basename(clip_name).split(".")[0]
        fields = base.split("_")
        emotion = fields[2] if len(fields) >= 4 else "neutral"
        level = 1
        for f in fields:
            if f.startswith("level"):
                try:
                    level = int(f[5:])
                except ValueError:
                    pass
        return self.caption(emotion, level, key=base)

    def build_captions(
        self, clip_names: Sequence[str], per_clip: int = 1
    ) -> Dict[str, List[str]]:
        """Caption JSON for MeadEmocaDataset(captions_path=...)."""
        out: Dict[str, List[str]] = {}
        for name in clip_names:
            caps = []
            for k in range(per_clip):
                gen = TalkClipGenerator(seed=self.seed + k, max_aus=self.max_aus)
                caps.append(gen.query(name))
            out[name] = caps
        return out
