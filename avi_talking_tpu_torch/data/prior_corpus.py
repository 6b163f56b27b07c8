"""The caption corpus for diffusion-prior training (port of
``avi_talking_tpu/data/prior_corpus.py``, the reference's
``prepare_train_data``).

Each training pair is an instruction caption and the style condition parsed
from its MEAD clip name. The caption goes through the frozen CLIP text
tower, meaned over all 77 tokens, into the prior's input ``voxel`` (the
reference's ``train_diffusion_prior.py:422-449``); the one-hot condition
goes through the frozen style encoder of the EMOTE head into the regression
target (:172-197). The corpus is listed, captioned and parsed once on the
host (``load_corpus_items``) and tokenized once (``tokenize_corpus``); each
batch gathers rows of that and runs both towers on their device under
``no_grad`` (``featurize``). The train / val split (``split_items``) keeps
all captions of one clip on one side. The permutations come from
``np.random.default_rng(seed)`` as in the JAX package, so both draw the
same batches.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .captions import CaptionDataset, MeadFilenameParser


@dataclasses.dataclass(frozen=True)
class PriorCorpusItem:
    """One (caption, style condition) training pair."""

    name: str
    caption: str
    identity_idx: int
    emotion_idx: int
    intensity_idx: int


def _parse_conditions(name: str, parser: MeadFilenameParser):
    try:
        return parser.parse(os.path.basename(name))
    except (ValueError, KeyError, IndexError):
        return None


def load_corpus_items(json_dir: Optional[str] = None, wav_dir: Optional[str] = None,
                      mead_root: Optional[str] = None, captions_path: Optional[str] = None,
                      caption_db=None,
                      parser: Optional[MeadFilenameParser] = None) -> List[PriorCorpusItem]:
    """(caption, condition) pairs from either corpus layout, or both:

    * ``json_dir`` (+ ``wav_dir``), the fixture corpus of
      ``experiments/json_dir``: conditions from the MEAD wav's name, one
      item per caption (the text after "###" dropped), named
      "<json stem>:<wav name>" so that rows sharing a wav split apart;
    * ``mead_root``, a ``build_index`` tree: conditions from the clip name,
      captions from the ``captions_path`` JSON (clip name -> caption(s)),
      else from ``caption_db`` (default ``TalkClipGenerator``).

    Names that do not parse as MEAD clips are left out."""
    parser = parser or MeadFilenameParser()
    items: List[PriorCorpusItem] = []
    if json_dir is not None:
        for ci in CaptionDataset(json_dir, wav_dir):
            src = os.path.basename(ci.wav_path or ci.name)
            cond = _parse_conditions(src, parser)
            if cond is None:
                continue
            for cap in ci.captions:
                cap = cap.split("###")[0].strip()
                if cap:
                    items.append(PriorCorpusItem(f"{ci.name}:{src}", cap, *cond))
    if mead_root is not None:
        from .mead import build_index

        caps_map: Dict[str, List[str]] = {}
        if captions_path and os.path.exists(captions_path):
            with open(captions_path) as f:
                caps_map = {k: ([v] if isinstance(v, str) else list(v))
                            for k, v in json.load(f).items()}
        if caption_db is None and not caps_map:
            from .caption_gen import TalkClipGenerator

            caption_db = TalkClipGenerator()
        for clip in build_index(mead_root):
            name = clip["name"]
            base = os.path.basename(name)
            cond = _parse_conditions(base, parser)
            if cond is None:
                continue
            caps = caps_map.get(name) or caps_map.get(base)
            if not caps and caption_db is not None:
                try:
                    caps = [caption_db.query(base)]
                except Exception:  # a database without the clip leaves it out
                    caps = None
            for cap in caps or ():
                items.append(PriorCorpusItem(name, cap, *cond))
    return items


def split_items(items: Sequence[PriorCorpusItem], val_fraction: float = 0.1,
                seed: int = 0) -> Tuple[List[PriorCorpusItem], List[PriorCorpusItem]]:
    """A deterministic (train, val) split by name: names ordered by crc32,
    ``round(val_fraction * n_names)`` of them to val (at least 1 and at most
    n - 1 where the fraction is nonzero and there are >= 2 names), so all
    captions of one clip land on one side."""
    if not 0.0 <= val_fraction < 1.0:
        raise ValueError(f"val_fraction {val_fraction} not in [0, 1)")
    names = sorted({it.name for it in items},
                   key=lambda n: zlib.crc32(f"{seed}:{n}".encode("utf-8")))
    n_val = int(round(val_fraction * len(names)))
    if val_fraction > 0 and len(names) >= 2:
        n_val = min(max(n_val, 1), len(names) - 1)
    val_names = set(names[:n_val])
    return ([it for it in items if it.name not in val_names],
            [it for it in items if it.name in val_names])


@dataclasses.dataclass
class PriorCorpusFeaturizer:
    """The frozen CLIP text tower and style encoder as the prior's batch
    source. ``featurize(ids, cond)`` gives, on the towers' device,

      voxel        = mean over all tokens of CLIP(ids)   (B, hidden)
      style_target = style_encoder(cond)                 (B, style dim)
    """

    clip_model: torch.nn.Module  # models.clip_text.ClipTextModel
    style_encoder: torch.nn.Module  # models.conditioning.EmotionStyleEncoder
    tokenizer: Callable[[Sequence[str]], np.ndarray]  # texts -> (B, 77) ids
    n_expression: int = 9
    n_intensities: int = 3
    n_identities: int = 32
    shape_dim: int = 300

    @classmethod
    def from_emote_head(cls, clip_model: torch.nn.Module, head: torch.nn.Module,
                        tokenizer: Callable[[Sequence[str]], np.ndarray],
                        **dims) -> "PriorCorpusFeaturizer":
        """The style encoder of an EMOTE head, the only part of it the
        reference's ``only_style_emb`` path runs."""
        return cls(clip_model=clip_model, style_encoder=head.style_encoder, tokenizer=tokenizer,
                   **dims)

    def tokenize_corpus(self, items: Sequence[PriorCorpusItem]) -> Dict[str, np.ndarray]:
        """All captions -> token ids, and the conditions -> one-hot rows
        [expression | intensity | identity | zero shape], once."""
        if not items:
            raise ValueError("empty corpus")
        ids = np.asarray(self.tokenizer([it.caption for it in items]), np.int32)
        n = len(items)
        cond = np.zeros((n, self.n_expression + self.n_intensities + self.n_identities
                         + self.shape_dim), np.float32)
        o = 0
        for arr, width in ((np.array([it.emotion_idx for it in items]), self.n_expression),
                           (np.array([it.intensity_idx for it in items]), self.n_intensities),
                           (np.array([it.identity_idx for it in items]), self.n_identities)):
            if arr.min() < 0 or arr.max() >= width:
                raise ValueError(
                    f"condition index out of range: {arr.min()}..{arr.max()} vs width {width}")
            cond[np.arange(n), o + arr] = 1.0
            o += width
        return {"ids": ids, "cond": cond}

    def featurize(self, ids: np.ndarray, cond: np.ndarray) -> Dict[str, torch.Tensor]:
        device = next(self.clip_model.parameters()).device
        with torch.no_grad():
            hidden = self.clip_model(torch.from_numpy(np.asarray(ids, np.int64)).to(device))
            style = self.style_encoder(torch.from_numpy(np.asarray(cond, np.float32)).to(device))
        return {"voxel": hidden.mean(dim=1), "style_target": style}


def prior_corpus_batches(items: Sequence[PriorCorpusItem], featurizer: PriorCorpusFeaturizer,
                         batch_size: int, steps: int,
                         seed: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    """``steps`` featurized batches over shuffled epochs; an epoch's short
    last slice is filled from the next epoch's permutation, so every batch
    holds ``batch_size`` rows."""
    feats = featurizer.tokenize_corpus(items)
    ids, cond = feats["ids"], feats["cond"]
    n = ids.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    pos = 0
    for _ in range(steps):
        take: List[np.ndarray] = []
        need = batch_size
        while need > 0:
            if pos >= n:
                perm = rng.permutation(n)
                pos = 0
            grab = min(need, n - pos)
            take.append(perm[pos:pos + grab])
            pos += grab
            need -= grab
        sel = np.concatenate(take)
        yield featurizer.featurize(ids[sel], cond[sel])


def make_val_batches(items: Sequence[PriorCorpusItem], featurizer: PriorCorpusFeaturizer,
                     batch_size: int, max_batches: int = 8, seed: int = 0):
    """A factory over a fixed set of validation batches, featurized once:
    min(max_batches, len(items) // batch_size), at least 1."""
    n_steps = max(1, min(max_batches, len(items) // max(batch_size, 1) or 1))
    cached = list(prior_corpus_batches(items, featurizer, batch_size, n_steps, seed))
    return lambda: iter(cached)
