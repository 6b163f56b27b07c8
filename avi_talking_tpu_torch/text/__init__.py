"""Text tokenization (offline CLIP byte-level BPE)."""

from .clip_bpe import ClipBpeTokenizer, find_tokenizer_assets, learn_bpe

__all__ = ["ClipBpeTokenizer", "find_tokenizer_assets", "learn_bpe"]
