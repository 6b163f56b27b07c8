"""MEAD subject (identity) splits (a copy of
``avi_talking_tpu/data/splits.py``; host only).

The 48 MEAD identities (27 male M*, 21 female W*) split by gender in
proportion, as inferno's ``get_subject_labels`` does; the 0.7 / 0.15 / 0.15
fractions give the 32-identity training set (18 M + 14 W). ``seed=None``
keeps the sorted order within each gender (the reference's effective
behaviour); a seed shuffles within gender. The roster of the released
EMOTE checkpoint (``captions.MEAD_TRAINING_IDS``) differs from this split in
one identity: use it for style indices, and this split for partitioning
training runs.
"""

from __future__ import annotations

import random as _random
from typing import Dict, List, Optional, Sequence

MEAD_IDENTITIES: List[str] = (
    "M003 M005 M007 M009 M011 M012 M013 M019 M022 M023 M024 M025 M026 "
    "M027 M028 M029 M030 M031 M032 M033 M034 M035 M037 M039 M040 M041 "
    "M042 W009 W011 W014 W015 W016 W017 W018 W019 W021 W023 W024 W025 "
    "W026 W028 W029 W033 W035 W036 W037 W038 W040"
).split()


def mead_identity_split(
    train: float = 0.7,
    val: float = 0.15,
    test: float = 0.15,
    seed: Optional[int] = None,
    identities: Optional[Sequence[str]] = None,
) -> Dict[str, List[str]]:
    """Gender-stratified identity partition -> {"train","val","test"} lists.

    ``seed=None`` reproduces the reference's effective behaviour (sorted
    order within gender). With the defaults the training set has exactly 32
    identities.
    """
    ids = sorted(identities if identities is not None else MEAD_IDENTITIES)
    total = train + val + test
    train_, val_ = train / total, val / total
    males = [i for i in ids if i.startswith("M")]
    females = [i for i in ids if not i.startswith("M")]
    if seed is not None:
        _random.Random(seed).shuffle(males)
        _random.Random(seed + 1).shuffle(females)
    out: Dict[str, List[str]] = {"train": [], "val": [], "test": []}
    for group in (males, females):
        n = len(group)
        a, b = int(n * train_), int(n * (train_ + val_))
        out["train"] += group[:a]
        out["val"] += group[a:b]
        out["test"] += group[b:]
    return out


def identity_of(clip_name: str) -> str:
    """'M003_front_neutral_level1_001' (possibly path-prefixed) -> 'M003'."""
    import os

    return os.path.basename(clip_name).split("_")[0]
