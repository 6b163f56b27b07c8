"""MEAD / EMOCA-preprocessed talking-face dataset (port of
``avi_talking_tpu/data/mead.py``: ``build_index``, ``ScreenedMeadAudio`` and
``MeadEmocaDataset``; host only, numpy).

Each clip directory holds per-frame EMOCA codes
(``EMOCA_v2_lr_mse_20/<frame>_000/{exp,pose,shape,cam}.npy``) and the clip's
wav. An item is a ``seq_length``-frame window (random for ``split="train"``,
leading otherwise) of coeff = concat[exp(50), jaw(3), global rotation(3),
cam(3)] z-normalised by ``CoeffStats``, with the audio sliced at 640 samples a
frame (16 kHz, 25 fps) and normalised Wav2Vec2Processor-style, the MEAD
filename's indices, the identity's neutral clip and an optional caption.
The windows and captions are drawn from ``np.random.default_rng(seed)`` in
the JAX package's order, so both packages give the same items.

The directory index is cached as ``index_cache.json`` in the root, in the
JAX package's format, so the two packages read one cache. With
``load_images=True`` an item also holds the window's detection crops
(``img``) and the leading window of the identity's neutral clip
(``ref_img``, the clip itself where the identity has no neutral clip), each
(T, H, W, 3) float32 in [-1, 1], decoded by ``viz/pngio.py``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..audio.frontend import SAMPLES_PER_FRAME, normalize_audio, read_wav
from .captions import MeadFilenameParser
from .stats import CoeffStats


def _scan_clip(root: str, name: str) -> Optional[Dict]:
    frames_dir = os.path.join(root, name, "EMOCA_v2_lr_mse_20")
    if not os.path.isdir(frames_dir):
        return None
    frame_names = sorted(
        fn for fn in os.listdir(frames_dir)
        if os.path.isdir(os.path.join(frames_dir, fn)) and "processed" not in fn
        and fn.endswith("_000"))
    if not frame_names:
        return None
    wav = os.path.join(root, name, name + ".wav")
    return {"name": name, "frames": [os.path.join(frames_dir, fn) for fn in frame_names],
            "wav": wav if os.path.exists(wav) else None}


def build_index(root: str, use_cache: bool = True) -> List[Dict]:
    """The clips under ``root`` (``<root>/<clip>`` or ``<root>/<group>/<clip>``),
    read from and written to ``<root>/index_cache.json`` with ``use_cache``."""
    cache = os.path.join(root, "index_cache.json")
    if use_cache and os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)
    clips = []
    for name in sorted(os.listdir(root)):
        if os.path.isfile(os.path.join(root, name)):
            continue
        meta = _scan_clip(root, name)
        if meta is None:  # nested layout <root>/<group>/<clip>
            for sub in sorted(os.listdir(os.path.join(root, name))):
                m = _scan_clip(root, os.path.join(name, sub))
                if m:
                    clips.append(m)
        else:
            clips.append(meta)
    if use_cache:
        try:
            with open(cache, "w") as f:
                json.dump(clips, f)
        except OSError:  # a read-only root still gives its index
            pass
    return clips


@dataclasses.dataclass
class ScreenedMeadAudio:
    """The clips of one or more MEAD roots that (a) scan, (b) have a wav,
    (c) get a caption from ``caption_db`` (default ``TalkClipGenerator``)
    and (d) whose wav is on the allowlist file (one path a line), where one
    is given: the reference's ``ScreenedMeadAudio`` and its
    ``meta_audio.txt``. ``wav_paths``, ``names`` and ``captions`` are sorted
    by wav path."""

    roots: Sequence[str]
    allowlist_path: Optional[str] = None
    caption_db: Optional[object] = None  # .query(name) -> caption

    def __post_init__(self):
        allow = None
        if self.allowlist_path:
            with open(self.allowlist_path) as f:
                allow = {ln.strip() for ln in f if ln.strip()}
        if self.caption_db is None:
            from .caption_gen import TalkClipGenerator

            self.caption_db = TalkClipGenerator()
        entries = []
        for root in self.roots:
            for clip in build_index(root):
                wav = clip.get("wav")
                if not wav:
                    continue
                try:
                    caption = self.caption_db.query(clip["name"])
                except Exception:  # a database without the clip leaves it out
                    continue
                if allow is not None and wav not in allow:
                    continue
                entries.append((wav, clip["name"], caption))
        entries.sort()
        self.wav_paths = [e[0] for e in entries]
        self.names = [e[1] for e in entries]
        self.captions = [e[2] for e in entries]

    def __len__(self) -> int:
        return len(self.wav_paths)


@dataclasses.dataclass
class MeadEmocaDataset:
    root: str
    seq_length: int = 25
    split: str = "train"
    stats: Optional[CoeffStats] = None
    smooth_pose: bool = False
    seed: int = 0
    captions_path: Optional[str] = None  # JSON: clip name -> caption or captions
    load_images: bool = False  # add the crops as ``img`` and ``ref_img``
    # None (all clips) or "train" / "val" / "test" of ``splits.mead_identity_split``
    subject_split: Optional[str] = None
    subject_split_seed: Optional[int] = None

    def __post_init__(self):
        self.index = build_index(self.root)
        if self.subject_split is not None:
            from .splits import identity_of, mead_identity_split

            allowed = set(mead_identity_split(seed=self.subject_split_seed)[self.subject_split])
            self.index = [c for c in self.index if identity_of(c["name"]) in allowed]
        self._captions = {}
        if self.captions_path and os.path.exists(self.captions_path):
            with open(self.captions_path) as f:
                self._captions = json.load(f)
        self.parser = MeadFilenameParser()
        self._rng = np.random.default_rng(self.seed)
        self._by_name = {c["name"]: c for c in self.index}
        # the first neutral clip of each identity
        self._neutral_by_id: Dict[str, str] = {}
        for clip in self.index:
            base = os.path.basename(clip["name"])
            if "_neutral_" in base:
                self._neutral_by_id.setdefault(base.split("_")[0], clip["name"])
        # identity statistics sized from the first clip's coefficients
        if self.stats is None and self.index:
            codes = self._load_codes(self.index[0]["frames"][:1])
            self.stats = CoeffStats.identity(self._raw_coeff(codes).shape[-1])

    def __len__(self) -> int:
        return len(self.index)

    def _load_codes(self, frames: List[str]) -> Dict[str, np.ndarray]:
        return {key: np.stack([np.load(os.path.join(fd, f"{key}.npy")) for fd in frames]
                              ).astype(np.float32)
                for key in ("exp", "pose", "shape", "cam")}

    def compute_stats(self, max_clips: int = 200) -> CoeffStats:
        """Coefficient statistics of the first ``max_clips`` clips."""
        coeffs = [self._raw_coeff(self._load_codes(clip["frames"]))
                  for clip in self.index[:max_clips]]
        return CoeffStats.from_data(np.concatenate(coeffs, axis=0))

    @staticmethod
    def _raw_coeff(codes: Dict[str, np.ndarray]) -> np.ndarray:
        return np.concatenate([codes["exp"][:, :50], codes["pose"][:, 3:6],
                               codes["pose"][:, :3], codes["cam"][:, :3]], axis=-1)  # (T, 59)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        clip = self.index[i]
        codes = self._load_codes(clip["frames"])
        if self.smooth_pose and codes["pose"].shape[0] > 15:
            from ..pipeline.postprocess import butter_lowpass_filtfilt

            codes["pose"][:, :3] = butter_lowpass_filtfilt(codes["pose"][:, :3])
        coeff = self._raw_coeff(codes)
        if self.stats is None:
            self.stats = CoeffStats.identity(coeff.shape[-1])
        T = coeff.shape[0]
        L = min(self.seq_length, T)
        start = int(self._rng.integers(0, T - L + 1)) if self.split == "train" else 0
        sl = slice(start, start + L)
        item: Dict[str, np.ndarray] = {
            "name": clip["name"],
            "coeff": self.stats.normalize(coeff[sl]).astype(np.float32),
            "shape": codes["shape"][sl],
            "pose": codes["pose"][sl],
            "cam": codes["cam"][sl],
        }
        if clip["wav"]:
            wav, _sr = read_wav(clip["wav"])
            seg = np.zeros(L * SAMPLES_PER_FRAME, np.float32)
            avail = wav[start * SAMPLES_PER_FRAME:(start + L) * SAMPLES_PER_FRAME]
            seg[:avail.shape[0]] = avail
            item["audio"] = normalize_audio(seg[None])
        base = os.path.basename(clip["name"])
        try:
            ident, emo, inten = self.parser.parse(base)
            item["identity_idx"] = np.int32(ident)
            item["emotion_idx"] = np.int32(emo)
            item["intensity_idx"] = np.int32(inten)
        except (ValueError, KeyError, IndexError):  # not a MEAD name
            pass
        neutral = self._neutral_by_id.get(base.split("_")[0])
        if neutral:
            item["neutral_clip"] = neutral
        caps = self._captions.get(clip["name"]) or self._captions.get(base)
        if caps:
            caps = [caps] if isinstance(caps, str) else list(caps)
            item["text"] = caps[int(self._rng.integers(0, len(caps)))
                                if self.split == "train" else 0]
        if self.load_images:
            img = self._load_image_window(clip, start, L)
            if img is not None:
                item["img"] = img
                ref_clip = self._by_name.get(item.get("neutral_clip"), clip)
                ref = self._load_image_window(ref_clip, 0, L)
                item["ref_img"] = ref if ref is not None else img
        return item

    def image_paths(self, i: int) -> List[str]:
        """The detection crops of clip ``i``, in frame order."""
        return self._clip_image_paths(self.index[i])

    @staticmethod
    def _clip_image_paths(clip: Dict) -> List[str]:
        """Per-frame detection crops, sorted to align with ``frames``: the
        first of four layouts that has any (under a ``processed_*``
        directory, one level deeper, beside the frames directory, or
        directly under the clip)."""
        frames_dir = os.path.dirname(clip["frames"][0])
        for pat in (
            os.path.join(frames_dir, "*", "detections", "*_000.png"),
            os.path.join(frames_dir, "*", "*", "detections", "*_000.png"),
            os.path.join(os.path.dirname(frames_dir), "*", "detections", "*_000.png"),
            os.path.join(os.path.dirname(frames_dir), "detections", "*_000.png"),
        ):
            cands = sorted(glob.glob(pat))
            if cands:
                return cands
        return []

    def _load_image_window(self, clip: Dict, start: int, length: int) -> Optional[np.ndarray]:
        """(length, H, W, 3) float32 in [-1, 1], or None where the clip has
        no crops; a short clip repeats its last crop."""
        from ..viz.pngio import read_image_normalized

        paths = self._clip_image_paths(clip)
        if not paths:
            return None
        return np.stack([read_image_normalized(paths[min(start + k, len(paths) - 1)])
                         for k in range(length)])
