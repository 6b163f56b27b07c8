"""Host-side data: captions and their generator, the prior's caption corpus,
MEAD / EMOCA and VOCASET datasets, their statistics, splits and batches."""

from .batching import batch_iterator, default_collate, pad_to_bucket
from .caption_gen import TalkClipGenerator
from .captions import MEAD_TRAINING_IDS, CaptionDataset, CaptionItem, MeadFilenameParser
from .mead import MeadEmocaDataset, ScreenedMeadAudio, build_index
from .splits import MEAD_IDENTITIES, identity_of, mead_identity_split
from .stats import CoeffStats
from .vocaset import VOCASET_SPLITS, VocasetDataset

__all__ = ["MEAD_IDENTITIES", "MEAD_TRAINING_IDS", "VOCASET_SPLITS", "CaptionDataset",
           "CaptionItem", "CoeffStats", "MeadEmocaDataset", "MeadFilenameParser",
           "ScreenedMeadAudio", "TalkClipGenerator", "VocasetDataset", "batch_iterator",
           "build_index", "default_collate", "identity_of", "mead_identity_split",
           "pad_to_bucket"]
