"""Host-side data helpers."""

from .batching import pad_to_bucket
from .captions import MEAD_TRAINING_IDS, CaptionDataset, CaptionItem, MeadFilenameParser

__all__ = ["MEAD_TRAINING_IDS", "CaptionDataset", "CaptionItem", "MeadFilenameParser",
           "pad_to_bucket"]
