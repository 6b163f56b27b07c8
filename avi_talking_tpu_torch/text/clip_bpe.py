"""Offline CLIP byte-level BPE tokenizer (pure Python; port of
``avi_talking_tpu/text/clip_bpe.py``: ``ClipBpeTokenizer``,
``find_tokenizer_assets``, the vocab files' ``validate_tokenizer_assets``,
``import_tokenizer_assets`` and ``save_vocab_files``, and ``learn_bpe``).

It implements HF ``CLIPTokenizer``'s algorithm over a local
``vocab.json`` + ``merges.txt`` pair, so token ids match HF and the JAX
package bit for bit:

1. clean: drop control chars / U+0000 / U+FFFD, map whitespace to ' ',
   surround CJK ideographs with spaces, NFC-normalize, split on whitespace,
   lowercase (accents kept), re-join with single spaces.
2. pre-tokenize with CLIP's regex
   ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|\\p{L}+|\\p{N}|[^\\s\\p{L}\\p{N}]+``
   (implemented as a hand scanner, no ``regex`` dependency).
3. byte-encode each pre-token (GPT-2 byte<->unicode table), append ``</w>``
   to the final symbol, and greedily apply BPE merges by rank.
4. ids = ``<|startoftext|>`` + tokens[:max_len-2] + ``<|endoftext|>``,
   padded with the eos id.
"""

from __future__ import annotations

import json
import os
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


# --------------------------------------------------------------------------
# byte <-> printable-unicode table (GPT-2 scheme: BPE operates on strings, so
# raw bytes are remapped to printable codepoints; published in the GPT-2 and
# CLIP tokenizers)
# --------------------------------------------------------------------------

def _byte_encoder() -> Dict[int, str]:
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    table = {b: chr(b) for b in printable}
    shift = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + shift)
            shift += 1
    return table


_BYTE_ENC = _byte_encoder()
_BYTE_DEC = {v: k for k, v in _BYTE_ENC.items()}


# --------------------------------------------------------------------------
# text cleanup (BasicTokenizer-equivalent: transformers tokenization_clip.py
# without ftfy installed)
# --------------------------------------------------------------------------

def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_whitespace_char(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control_char(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def clean_text(text: str) -> str:
    """Whitespace/control cleanup + CJK spacing + NFC + lowercase."""
    kept = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control_char(ch):
            continue
        if _is_whitespace_char(ch):
            kept.append(" ")
        elif _is_cjk(cp):
            kept.append(f" {ch} ")
        else:
            kept.append(ch)
    text = unicodedata.normalize("NFC", "".join(kept))
    return " ".join(tok.lower() for tok in text.split())


# --------------------------------------------------------------------------
# pre-tokenizer: hand scanner equivalent to CLIP's regex on cleaned text
# --------------------------------------------------------------------------

def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def pre_tokenize(text: str) -> List[str]:
    """Split cleaned text the way CLIP's regex does (alternation order:
    specials, contractions, letter runs, single number, symbol runs)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch == " ":
            i += 1
            continue
        if ch == "<":
            matched = False
            for sp in _SPECIALS:
                if text.startswith(sp, i):
                    out.append(sp)
                    i += len(sp)
                    matched = True
                    break
            if matched:
                continue
        if ch == "'":
            matched = False
            for con in _CONTRACTIONS:
                if text.startswith(con, i):
                    out.append(con)
                    i += len(con)
                    matched = True
                    break
            if matched:
                continue
        if _is_letter(ch):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
            out.append(text[i:j])
            i = j
        elif _is_number(ch):
            out.append(ch)
            i += 1
        else:
            # run of symbols: anything that is not space/letter/number.
            # NB apostrophes inside the run are swallowed (regex is greedy and
            # only starts a contraction match at a fresh position).
            j = i + 1
            while j < n and not (
                text[j] == " " or _is_letter(text[j]) or _is_number(text[j])
            ):
                j += 1
            out.append(text[i:j])
            i = j
    return out


# --------------------------------------------------------------------------
# tokenizer
# --------------------------------------------------------------------------

class ClipBpeTokenizer:
    """HF-``CLIPTokenizer``-compatible encoder over local vocab/merges files.

    ``vocab`` maps token string -> id; ``merges`` is the ranked list of
    symbol pairs. Both come from the standard ``vocab.json``/``merges.txt``
    pair (``from_files`` / ``from_dir``).
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        max_length: int = 77,
    ):
        self.vocab = dict(vocab)
        self.ranks = {pair: r for r, pair in enumerate(merges)}
        self.max_length = max_length
        self.bos_id = self.vocab["<|startoftext|>"]
        self.eos_id = self.vocab["<|endoftext|>"]
        self.unk_id = self.eos_id  # HF: unk_token == eos_token
        self._cache: Dict[str, List[str]] = {s: [s] for s in _SPECIALS}

    # -- construction -----------------------------------------------------

    @classmethod
    def from_files(
        cls, vocab_file: os.PathLike, merges_file: os.PathLike, max_length: int = 77
    ) -> "ClipBpeTokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            # line 0 is the "#version" header; HF additionally caps the list
            # at 49152-256-2 merges (the real CLIP file has trailing junk)
            lines = f.read().strip().split("\n")[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines]
        return cls(vocab, merges, max_length=max_length)

    @classmethod
    def from_dir(cls, path: os.PathLike, max_length: int = 77) -> "ClipBpeTokenizer":
        path = Path(path)
        return cls.from_files(path / "vocab.json", path / "merges.txt", max_length)

    # -- core -------------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            best_rank, best_idx = None, -1
            for i in range(len(word) - 1):
                r = self.ranks.get((word[i], word[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_idx = r, i
            if best_rank is None:
                break
            first, second = word[best_idx], word[best_idx + 1]
            # merge every (first, second) occurrence, left to right
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def tokenize(self, text: str) -> List[str]:
        pieces: List[str] = []
        for tok in pre_tokenize(clean_text(text)):
            if tok in _SPECIALS:
                pieces.append(tok)
                continue
            btok = "".join(_BYTE_ENC[b] for b in tok.encode("utf-8"))
            pieces.extend(self._bpe(btok))
        return pieces

    def encode(self, text: str) -> List[int]:
        """bos + tokens (truncated to max_length-2) + eos, no padding."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = ids[: self.max_length - 2]
        return [self.bos_id] + ids + [self.eos_id]

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """(B, max_length) int32, padded with the eos id (HF pad_token)."""
        out = np.full((len(texts), self.max_length), self.eos_id, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids: Sequence[int]) -> str:
        inv = {v: k for k, v in self.vocab.items()}
        text = "".join(inv.get(int(i), "") for i in ids)
        for sp in _SPECIALS:
            text = text.replace(sp, "")
        raw = bytearray(_BYTE_DEC[c] for c in text if c in _BYTE_DEC)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


# --------------------------------------------------------------------------
# asset discovery
# --------------------------------------------------------------------------

def find_tokenizer_assets(explicit: Optional[os.PathLike] = None) -> Optional[Path]:
    """Locate a vocab.json+merges.txt pair: explicit arg > env var >
    repo assets/clip_tokenizer > HF hub cache (any cached CLIP snapshot)."""
    candidates: List[Path] = []
    if explicit is not None:
        candidates.append(Path(explicit))
    env = os.environ.get("AVI_TALKING_CLIP_TOKENIZER")
    if env:
        candidates.append(Path(env))
    candidates.append(Path(__file__).resolve().parents[2] / "assets" / "clip_tokenizer")
    hub = Path(os.environ.get("HF_HOME", Path.home() / ".cache" / "huggingface")) / "hub"
    if hub.is_dir():
        for model_dir in sorted(hub.glob("models--*clip*")):
            candidates.extend(sorted(model_dir.glob("snapshots/*")))
    for c in candidates:
        if (c / "vocab.json").is_file() and (c / "merges.txt").is_file():
            return c
    return None


def validate_tokenizer_assets(path: os.PathLike) -> "ClipBpeTokenizer":
    """Load and check a vocab / merges pair; raises ``ValueError`` on a bad
    layout. The layout rules of the real CLIP vocab: both specials at ids
    V-2 (``<|startoftext|>``) and V-1 (``<|endoftext|>``), 49406 / 49407 for
    the real 49408-token vocab; all 256 byte symbols and their ``</w>``
    variants present; ids exactly 0..V-1; a pinned sample round-trips."""
    path = Path(path)
    tok = ClipBpeTokenizer.from_dir(path)
    v = tok.vocab
    V = len(v)
    if v.get("<|startoftext|>") != V - 2 or v.get("<|endoftext|>") != V - 1:
        raise ValueError(
            f"{path}: specials misplaced (start={v.get('<|startoftext|>')}, "
            f"end={v.get('<|endoftext|>')}, vocab={V}); expected V-2/V-1")
    missing = [s for s in _BYTE_ENC.values() if s not in v or s + "</w>" not in v]
    if missing:
        raise ValueError(f"{path}: {len(missing)} byte symbols missing (e.g. {missing[:3]})")
    if sorted(v.values()) != list(range(V)):
        raise ValueError(f"{path}: vocab ids are not a dense 0..{V - 1} range")
    # no punctuation: decode joins word pieces with single spaces
    sample = "a joyful person speaks with lifted cheek and parted lips"
    if tok.decode(tok.encode(sample)) != sample:
        raise ValueError(f"{path}: pinned sample does not round-trip")
    return tok


def import_tokenizer_assets(src: os.PathLike, dest: Optional[os.PathLike] = None) -> Path:
    """Validate vocab.json / merges.txt and copy them into ``dest`` (default
    the repository's ``assets/clip_tokenizer/``, which
    ``find_tokenizer_assets`` probes after the env var), then validate the
    copy. ``src`` may be the pair's directory, an HF hub cache root (its
    ``models--*clip*/snapshots/*``) or any tree holding the pair."""
    import shutil

    src = Path(src)
    found: Optional[Path] = None
    if (src / "vocab.json").is_file() and (src / "merges.txt").is_file():
        found = src
    else:
        for pat in ("models--*clip*/snapshots/*", "hub/models--*clip*/snapshots/*", "**/"):
            found = next((c for c in sorted(src.glob(pat))
                          if (c / "vocab.json").is_file() and (c / "merges.txt").is_file()),
                         None)
            if found:
                break
    if found is None:
        raise FileNotFoundError(
            f"no vocab.json+merges.txt pair under {src} (pass the snapshot dir of a "
            "cached openai/clip model, or any dir holding the pair)")
    validate_tokenizer_assets(found)
    dest = Path(dest) if dest is not None else (
        Path(__file__).resolve().parents[2] / "assets" / "clip_tokenizer")
    dest.mkdir(parents=True, exist_ok=True)
    for fn in ("vocab.json", "merges.txt"):
        shutil.copyfile(found / fn, dest / fn)
    validate_tokenizer_assets(dest)
    return dest


def learn_bpe(corpus: Sequence[str], num_merges: int
              ) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """Learn a merge table and a CLIP-layout vocab from raw text (the
    standard Sennrich et al. loop). The vocab is laid out as the real CLIP
    file: 256 byte symbols, the same 256 with ``</w>``, one token per merge
    in rank order, then the two specials, so the result round-trips through
    HF ``CLIPTokenizer``. Each merge takes the most frequent pair, ties
    broken lexicographically; the loop stops early when no pair occurs
    twice."""
    word_freq: Dict[Tuple[str, ...], int] = {}
    for line in corpus:
        for tok in pre_tokenize(clean_text(line)):
            if tok in _SPECIALS:
                continue
            btok = "".join(_BYTE_ENC[b] for b in tok.encode("utf-8"))
            key = tuple(btok[:-1]) + (btok[-1] + "</w>",)
            word_freq[key] = word_freq.get(key, 0) + 1

    merges: List[Tuple[str, str]] = []
    for _ in range(num_merges):
        pair_freq: Dict[Tuple[str, str], int] = {}
        for word, freq in word_freq.items():
            for a, b in zip(word, word[1:]):
                pair_freq[(a, b)] = pair_freq.get((a, b), 0) + freq
        if not pair_freq:
            break
        top = max(pair_freq.values())
        best = min(p for p, f in pair_freq.items() if f == top)
        if pair_freq[best] < 2:
            break
        merges.append(best)
        first, second = best
        new_freq: Dict[Tuple[str, ...], int] = {}
        for word, freq in word_freq.items():
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            key = tuple(out)
            new_freq[key] = new_freq.get(key, 0) + freq
        word_freq = new_freq

    byte_symbols = [_BYTE_ENC[b] for b in range(256)]
    tokens = byte_symbols + [s + "</w>" for s in byte_symbols]
    tokens += [a + b for a, b in merges]
    tokens += list(_SPECIALS)
    return {tok: i for i, tok in enumerate(tokens)}, merges


def save_vocab_files(vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                     out_dir: os.PathLike) -> Tuple[Path, Path]:
    """Write HF-format vocab.json + merges.txt (loadable by CLIPTokenizer)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    vocab_file, merges_file = out / "vocab.json", out / "merges.txt"
    vocab_file.write_text(json.dumps(vocab, ensure_ascii=False, sort_keys=True),
                          encoding="utf-8")
    merges_file.write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n",
        encoding="utf-8")
    return vocab_file, merges_file
