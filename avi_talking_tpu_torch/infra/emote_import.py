"""EMOTE checkpoint importer: an inferno TalkingHead ``.ckpt`` state dict ->
the port's ``EmoteTalkingHead`` state (port of
``avi_talking_tpu/infra/emote_import.py``).

The pretrained EMOTE layout (inferno's TalkingHeadBase attribute tree, the
Lightning ``state_dict`` under ``talking_head_model.`` or bare):

    audio_model.model.*                        -> audio_encoder (HF wav2vec2)
    sequence_encoder.linear.*                  -> sequence_encoder
    sequence_decoder.obj_vector.map.*          -> style_encoder.map
    sequence_decoder.bert_decoder.layers.*     -> bert_decoder
    sequence_decoder.decoder.*                 -> decoder
    sequence_decoder.squasher_2.linear.*       -> squasher (stack_linear), or
    sequence_decoder.[squasher|squasher_2].squasher.N.{0,2}.* (conv)
    sequence_decoder.motion_prior.motion_decoder.* -> motion_prior (FLINT)

The port's modules follow the reference's names, so the work is the
prefixes, the squasher's variants and the weight norm of wav2vec2's
positional conv (``audio.wav2vec2.wav2vec2_state_from_torch``). A key the
mapping needs and the checkpoint lacks raises ``KeyError`` listing the
checkpoint's keys that nothing read and no ignore pattern covers, where
JAX's ``_TrackedDict`` raises. BatchNorm step counters are set to 0 (flax
keeps none).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import torch

from ..audio.wav2vec2 import wav2vec2_state_from_torch
from ..models.emote import EmoteConfig

# checkpoint families a full EMOTE .ckpt carries that the inference graph
# does not use (JAX's IGNORED_KEY_PATTERNS): the motion prior's encoder
# half, non-learned masks, BatchNorm step counters, the pseudo-GT
# preprocessor, FLAME buffers, wav2vec2's SpecAugment embedding
IGNORED_KEY_PATTERNS: Tuple[str, ...] = (
    r"\.num_batches_tracked$",
    r"(^|\.)motion_prior\.motion_encoder\.",
    r"(^|\.)motion_prior\.motion_quantizer\.",
    r"(^|\.)motion_prior\.preprocessor\.",
    r"(^|\.)preprocessor\.",
    r"(^|\.)motion_prior\..*\.attention_mask",
    r"(^|\.)motion_prior\..*decoder_pos_embedding",
    r"(^|\.)biased_mask",
    r"(^|\.)flame\.",
    r"masked_spec_embed$",
)


def _is_ignored(key: str) -> bool:
    return any(re.search(p, key) for p in IGNORED_KEY_PATTERNS)


class _Reader(dict):
    """A view of the checkpoint under a prefix that records every key read,
    under its full name, so a missing key can list what was left over."""

    def __init__(self, data: Mapping[str, Any], consumed: set, prefix: str = ""):
        super().__init__(data)
        self.consumed, self.prefix = consumed, prefix

    def __getitem__(self, k):
        self.consumed.add(self.prefix + k)
        return super().__getitem__(k)

    def sub(self, prefix: str) -> "_Reader":
        return _Reader({k[len(prefix):]: v for k, v in self.items() if k.startswith(prefix)},
                       self.consumed, self.prefix + prefix)

    def first_prefix(self, cands) -> str:
        for c in cands:
            if any(k.startswith(c) for k in self):
                return c
        raise KeyError(f"none of the prefixes {cands} found; keys look like {list(self)[:5]}")


def _put(out: Dict[str, torch.Tensor], dst: str, sd: Mapping[str, Any], src: str,
         names=("weight", "bias")) -> None:
    """``dst + name`` <- ``src + name`` for each name; a bias is optional."""
    for n in names:
        if n == "bias" and src + n not in sd:
            continue
        out[dst + n] = torch.as_tensor(sd[src + n])


def _batchnorm(out, dst, sd, src) -> None:
    _put(out, dst, sd, src, ("weight", "bias", "running_mean", "running_var"))
    out[dst + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def _encoder(out, dst, sd, src, num_layers: int) -> None:
    """torch ``TransformerEncoder`` layers: the port's names are torch's."""
    for i in range(num_layers):
        lp = f"layers.{i}."
        _put(out, dst + lp + "self_attn.", sd, src + lp + "self_attn.",
             ("in_proj_weight", "in_proj_bias"))
        for m in ("self_attn.out_proj.", "linear1.", "linear2.", "norm1.", "norm2."):
            _put(out, dst + lp + m, sd, src + lp + m)


def _flint(out, sd: _Reader, cfg: EmoteConfig) -> None:
    fc = cfg.flint
    _put(out, "motion_prior.expander.0.0.", sd, "expander.0.0.")
    _batchnorm(out, "motion_prior.expander.0.2.", sd, "expander.0.2.")
    for i in range(1, fc.quant_factor):
        _put(out, f"motion_prior.expander.{i}.0.", sd, f"expander.{i}.0.")
        _batchnorm(out, f"motion_prior.expander.{i}.2.", sd, f"expander.{i}.2.")
    _put(out, "motion_prior.decoder_linear_embedding.", sd, "decoder_linear_embedding.")
    n_layers = 0
    while f"decoder_transformer.layers.{n_layers}.self_attn.in_proj_weight" in sd:
        n_layers += 1
    _encoder(out, "motion_prior.decoder_transformer.", sd, "decoder_transformer.", n_layers)
    for name, flag in (("post_transformer_linear", "post_transformer_proj"),
                       ("post_conv_proj", "post_conv_proj")):
        if any(k.startswith(name + ".") for k in sd):
            if not getattr(fc, flag):
                raise ValueError(f"checkpoint has motion_prior {name} weights but "
                                 f"FlintConfig.{flag} is False: the graft would drop them")
            _put(out, f"motion_prior.{name}.", sd, name + ".")
    _put(out, "motion_prior.cross_smooth_layer.", sd, "cross_smooth_layer.")


def _squasher(out, dec: _Reader, cfg: EmoteConfig) -> None:
    """Both squasher placements and both types, validated against the
    config (JAX's ``_squasher_params``)."""
    for base, before in (("squasher_2.", False), ("squasher.", True)):
        if any(k.startswith(base + "linear.") for k in dec):
            kind = "stack_linear"
        elif any(k.startswith(base + "squasher.") for k in dec):
            kind = "conv"
        else:
            continue
        if cfg.squash_type != kind or cfg.squash_before != before:
            raise ValueError(
                f"checkpoint squasher is {kind} (squash_before={before}) but EmoteConfig has "
                f"squash_type={cfg.squash_type!r} squash_before={cfg.squash_before}")
        if kind == "stack_linear":
            _put(out, "squasher.", dec, base + "linear.")
        else:
            for i in range(cfg.flint.quant_factor):
                _put(out, f"squasher.squasher.{i}.0.", dec, f"{base}squasher.{i}.0.")
                _batchnorm(out, f"squasher.squasher.{i}.2.", dec, f"{base}squasher.{i}.2.")
        return
    raise KeyError("no squasher weights found (expected squasher_2.linear / squasher.linear / "
                   f"[squasher|squasher_2].squasher.N); keys look like {sorted(dec)[:5]}")


def emote_state_from_torch(sd: Mapping[str, Any], cfg: EmoteConfig) -> Dict[str, torch.Tensor]:
    """A full EMOTE state dict -> ``EmoteTalkingHead`` state (the style
    encoder's ``map`` included)."""
    consumed: set = set()
    root = _Reader(sd, consumed)
    try:
        base = root.first_prefix(("talking_head_model.", ""))
        top = root.sub(base)
        out: Dict[str, torch.Tensor] = {}
        audio = top.sub(top.first_prefix(("audio_model.model.", "audio_model.")))
        for k, v in wav2vec2_state_from_torch(audio, cfg.wav2vec2).items():
            out["audio_encoder." + k] = v
        _put(out, "sequence_encoder.", top,
             top.first_prefix(("sequence_encoder.linear.", "sequence_encoder.")))
        dec = top.sub("sequence_decoder.")
        _put(out, "style_encoder.map.", dec, "obj_vector.map.")
        if any(k.startswith("bert_decoder.") for k in dec):
            _encoder(out, "bert_decoder.", dec, "bert_decoder.", cfg.num_layers)
        _put(out, "decoder.", dec, "decoder.")
        _squasher(out, dec, cfg)
        _flint(out, dec.sub(dec.first_prefix(("motion_prior.motion_decoder.",
                                              "motion_prior.decoder."))), cfg)
    except KeyError as e:
        left = unread_keys(sd, consumed)
        raise KeyError(f"EMOTE checkpoint: {e}; keys nothing read ({len(left)}): "
                       f"{left[:20]}") from e
    return out


def unread_keys(sd: Mapping[str, Any], consumed: set) -> List[str]:
    """The checkpoint's keys that were not read and match no ignore
    pattern."""
    return sorted(k for k in sd if k not in consumed and not _is_ignored(k))
