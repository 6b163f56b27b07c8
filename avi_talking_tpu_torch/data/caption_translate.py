"""Offline Style-B -> Style-A caption translation, CelebV-Text -> MEAD-text
(port of ``avi_talking_tpu/data/caption_translate.py``; host logic, as in
JAX).

The reference translates verbose "Style B" FACS descriptions ("The anger
is inferred from the lowered brow, ...") into the compact "Style A"
instructions the diffusion prior trains on ("A fairly angry man speaks
with brow fairly down.") through an external LLM. This is the same job as
a deterministic rule-based translator over the same primitives: an emotion
lexicon at 3 intensity levels, AU surface forms mapped onto the EMFACS AU
ids of ``data.caption_gen`` (the shared vocabulary), and the Style-A
sentence frames of the reference's prompt. ``build_translation_prompt``
builds that prompt for users with an LLM endpoint.
"""

from __future__ import annotations

import dataclasses
import re
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .caption_gen import AU_PHRASES, INTENSITY_ADVERBS

# emotion -> keyword cues found in Style-B prose (incl. nouns the reference
# lexicon lists under feel/show/attr)
EMOTION_CUES: Dict[str, Tuple[str, ...]] = {
    "angry": ("anger", "angry", "frustrat", "rage", "furious", "outrage",
              "resent", "hostil", "irritat", "annoy", "grouchy", "wrath"),
    "contempt": ("contempt", "scorn", "disdain"),
    "disgusted": ("disgust", "appalled", "sicken", "repuls"),
    "fear": ("fear", "scared", "horror", "insecur", "terrif", "anxious",
             "fright"),
    "happy": ("happi", "happy", "joy", "smile", "smiling", "content",
              "delight", "cheer"),
    "sad": ("sad", "grief", "sorrow", "gloomy", "disappoint", "downcast"),
    "surprised": ("surpris", "shock", "astonish", "startl"),
    "neutral": ("neutral", "calm", "impassive", "detach", "relaxed"),
}

# Style-B surface forms -> EMFACS AU id (superset of AU_PHRASES wording:
# Style B uses gerunds/passives — "lowering the brow", "lips separated")
AU_CUES: Tuple[Tuple[str, int], ...] = (
    (r"inner (eye)?brow", 1),
    (r"outer (eye)?brow", 2),
    (r"lower(ing|ed)? (of )?(the )?brow|brow[s]? (being )?(furrow|lower|down)|furrowed brow", 4),
    (r"upper (eye)?lid", 5),
    (r"rais(ing|ed)? (of )?(the )?cheek|cheek[s]? (being )?(lift|rais)|lifted cheek|puffed out cheek", 6),
    (r"narrowed eye|squint|tension.*lower eyelid|lower eyelid.*tension", 7),
    (r"nose|nostril", 9),
    (r"upper lip", 10),
    (r"lip corner|corner[s]? of the (mouth|lip)|pull(ing|ed)? (of )?(the )?lip", 12),
    (r"dimpl", 14),
    (r"mouth.*downwards|downward pull of the mouth", 15),
    (r"chin", 17),
    (r"stretch(ing|ed)? (of )?(the )?lip|lip[s]? (being )?stretch", 20),
    (r"tighten(ing|ed)? (of )?(the )?(lower )?lip|pursed lip", 23),
    (r"separat(ing|ion|ed)? (of )?(the |their )?lip|lips? (being )?(separat|part)|parted lip", 25),
    (r"dropp?(ing|ed)? (of )?(the |their )?jaw|jaw.*dropp", 26),
)

_LEVEL_CUES: Tuple[Tuple[str, int], ...] = (
    (r"extreme|very |fully|strongly|significantly|deep", 3),
    (r"fairly|quite|pretty|noticeabl", 2),
    (r"slightly|mildly|marginally|lightly|minimal|faint", 1),
)

# Style-A frames from the reference prompt ("Summarized ... with one of
# following structures", style_celebv2meadtext.py)
_FRAMES_WITH_AUS = (
    "A {adj} man speaks with {body}.",
    "A man feels {adj} and speaks with {body}.",
    "A man displays {noun} and speaks with {body}.",
)
_FRAMES_NO_AUS = (
    "A {adj} man.",
    "A man feels {adj}.",
)

# per-emotion adjective/noun pools by level (condensed reference lexicon)
_LEXICON: Dict[str, Dict[int, Tuple[Tuple[str, ...], Tuple[str, ...]]]] = {
    # emotion -> level -> (adjectives, display-nouns)
    "angry": {
        1: (("mildly angry", "grouchy", "irritated"), ("irritation",)),
        2: (("fairly angry", "resentful", "frustrated"), ("anger", "resentment")),
        3: (("extremely angry", "furious", "outraged"), ("rage", "fury")),
    },
    "contempt": {
        1: (("mildly scornful", "slightly disdainful"), ("mild scorn",)),
        2: (("fairly contemptuous", "quite scornful"), ("scorn",)),
        3: (("extremely contemptuous", "very disdainful"), ("deep scorn",)),
    },
    "disgusted": {
        1: (("mildly disgusted", "slightly appalled"), ("mild dislike",)),
        2: (("fairly disgusted", "quite appalled"), ("dislike",)),
        3: (("extremely disgusted", "very sickened"), ("revulsion",)),
    },
    "fear": {
        1: (("mildly scared", "slightly anxious"), ("unease",)),
        2: (("fairly scared", "quite fearful"), ("insecurity", "fear")),
        3: (("extremely scared", "terrified"), ("horror", "terror")),
    },
    "happy": {
        1: (("mildly joyous", "slightly happy"), ("mild pleasure",)),
        2: (("fairly happy", "quite cheerful"), ("happiness", "joy")),
        3: (("extremely happy", "elated"), ("delight", "elation")),
    },
    "sad": {
        1: (("slightly sad", "mildly gloomy"), ("mild sadness",)),
        2: (("fairly sad", "disappointed", "gloomy"), ("sadness", "sorrow")),
        3: (("extremely sad", "despairing"), ("grief", "despair")),
    },
    "surprised": {
        1: (("mildly surprised",), ("mild surprise",)),
        2: (("fairly surprised", "quite astonished"), ("surprise",)),
        3: (("extremely surprised", "shocked"), ("shock", "astonishment")),
    },
    "neutral": {
        1: (("impassive",), ()),
        2: (("impassive", "composed"), ()),
        3: (("impassive", "calm"), ()),
    },
}


@dataclasses.dataclass(frozen=True)
class ParsedCaption:
    emotion: str
    level: int
    aus: Tuple[int, ...]


def parse_style_b(sentence: str) -> ParsedCaption:
    """Extract (emotion, intensity level, AU ids) from Style-B prose."""
    s = sentence.lower()
    emotion, best = "neutral", 0
    for emo, cues in EMOTION_CUES.items():
        hits = sum(s.count(c) for c in cues)
        if hits > best or (hits == best and best > 0 and emo != "neutral"
                           and emotion == "neutral"):
            emotion, best = emo, hits
    level = 2
    for pat, lv in _LEVEL_CUES:
        if re.search(pat, s):
            level = lv
            break
    aus: List[int] = []
    for pat, au in AU_CUES:
        if re.search(pat, s) and au not in aus:
            aus.append(au)
    return ParsedCaption(emotion, level, tuple(aus))


def _fix_article(sentence: str) -> str:
    return re.sub(r"\bA ([aeiouAEIOU])", r"An \1", sentence)


def translate_style_b_to_a(
    sentence: str, seed: int = 0, max_aus: int = 4
) -> str:
    """One Style-B caption -> one Style-A instruction (deterministic per
    (sentence, seed))."""
    parsed = parse_style_b(sentence)
    rng = np.random.default_rng((seed, zlib.crc32(sentence.encode("utf-8"))))
    adjs, nouns = _LEXICON[parsed.emotion][parsed.level]
    adj = adjs[int(rng.integers(0, len(adjs)))]
    aus = list(parsed.aus[:max_aus])
    if not aus or parsed.emotion == "neutral":
        return _fix_article(_FRAMES_NO_AUS[
            int(rng.integers(0, len(_FRAMES_NO_AUS)))].format(adj=adj))
    adverbs = INTENSITY_ADVERBS[parsed.level]
    parts = []
    for au in aus:
        adv = adverbs[int(rng.integers(0, len(adverbs)))]
        phrase = AU_PHRASES[au]
        if rng.integers(0, 2) and " " in phrase:
            verb, noun = phrase.split(" ", 1)
            parts.append(f"{noun} {adv} {verb}")
        else:
            parts.append(f"{adv} {phrase}")
    body = (", ".join(parts[:-1]) + f", and {parts[-1]}") if len(parts) > 1 \
        else parts[0]
    frames = list(_FRAMES_WITH_AUS if nouns else _FRAMES_WITH_AUS[:2])
    frame = frames[int(rng.integers(0, len(frames)))]
    noun = nouns[int(rng.integers(0, len(nouns)))] if nouns else ""
    return _fix_article(frame.format(adj=adj, noun=noun, body=body))


def translate_corpus(
    sentences: Sequence[str], seed: int = 0
) -> List[str]:
    return [translate_style_b_to_a(s, seed) for s in sentences]


def build_translation_prompt(
    style_b_sentences: Sequence[str],
    style_a_examples: Optional[Sequence[str]] = None,
) -> str:
    """Reproduce the reference's LLM prompt construction
    (style_celebv2meadtext.py: Style A examples + Style B block + frame
    list) for users with an LLM endpoint."""
    a_block = "\n".join(style_a_examples or _DEFAULT_STYLE_A_EXAMPLES)
    b_block = "\n".join(style_b_sentences)
    frames = "\n".join(_FRAMES_WITH_AUS + _FRAMES_NO_AUS).replace(
        "{adj}", "_").replace("{noun}", "_").replace("{body}", "_")
    return (
        f"Style A:\n{a_block}\n\nStyle B sentences:\n{b_block}\n\n"
        f"Summarized Style B sentences with one of following structures:\n"
        f"{frames}\n"
    )


_DEFAULT_STYLE_A_EXAMPLES = (
    "A fairly angry man speaks with brow fairly down.",
    "A man feels slightly sad.",
    "A mildly joyous man speaks with lip corner lightly pulled.",
    "An impassive man.",
)
