"""Text tokenization (offline CLIP byte-level BPE)."""

from .clip_bpe import ClipBpeTokenizer, find_tokenizer_assets

__all__ = ["ClipBpeTokenizer", "find_tokenizer_assets"]
