"""Stage-1 FaceFormer: autoregressive audio -> FLAME-coefficient decoder
(port of ``avi_talking_tpu/models/faceformer.py``).

  audio -> wav2vec2 (resampled to the frame count; K1 in every layer)
        -> Linear(768 -> D) memory
  optional conditioning merge: concat[eye(6), emo(30), audio(D), ref-style(6)]
        -> Linear(-> D)
  decode: token t-1 -> Linear(coeff -> D) -> periodic positional encoding
        -> one post-LN decoder layer (K3 in its self-attention with the
        periodised-ALiBi causal bias and in its cross-attention with the
        diagonal alignment bias) -> Linear(D -> coeff, zero-init)

``forward`` is the teacher-forced training pass; ``predict`` the KV-cached
autoregressive decode of ``models/ar_decode.py``.

``dtype`` is flax's ``dtype`` of ``FaceFormerCoeff(cfg, dtype=...)``: the
compute type (``ops.layers.set_compute_dtype``), bfloat16 on the card's
fast path, over float32 parameters. The linear maps cast their inputs to it
(the float32 coefficients, eye / emotion embeddings and reference
coefficients), so ``forward``, ``merge_condition`` and ``predict`` run and
return it; the decoder's attention biases stay float32, as JAX builds them,
and K3 reads them so beside bfloat16 q, k and v.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..audio.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from ..infra.device import resolve_device
from ..infra.init import random_module
from ..ops.layers import Linear, set_compute_dtype
from ..ops.positional import (
    enc_dec_alignment_bias,
    faceformer_bias,
    periodic_positional_encoding,
)
from ..ops.transformer import TransformerDecoder
from .ar_decode import ar_decode


@dataclasses.dataclass(frozen=True)
class FaceFormerConfig:
    vertice_dim: int = 53  # 50 exp + 3 jaw (normalised coeff space)
    feature_dim: int = 128
    period: int = 25
    nhead: int = 4
    num_decoder_layers: int = 1
    max_seq_len: int = 600
    with_condition_merge: bool = True
    eye_dim: int = 6
    emo_dim: int = 30
    style_dim: int = 6
    wav2vec2: Wav2Vec2Config = dataclasses.field(default_factory=Wav2Vec2Config)

    @classmethod
    def tiny(cls) -> "FaceFormerConfig":
        return cls(vertice_dim=9, feature_dim=32, period=5, max_seq_len=64,
                   wav2vec2=Wav2Vec2Config.tiny())


class FaceFormerCoeff(nn.Module):
    def __init__(self, cfg: FaceFormerConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.cfg = cfg
        D = c.feature_dim
        self.audio_encoder = Wav2Vec2Model(c.wav2vec2)
        self.audio_feature_map = Linear(c.wav2vec2.hidden_size, D)
        self.vertice_map = Linear(c.vertice_dim, D)
        self.vertice_map_r = Linear(D, c.vertice_dim)
        self.obj_embedding = nn.Parameter(torch.empty(1, D))
        self.transformer_decoder = TransformerDecoder(
            c.num_decoder_layers, D, c.nhead, 2 * D, activation="relu")
        if c.with_condition_merge:
            self.coeff2style = Linear(c.vertice_dim, c.style_dim)
            self.v_merge2hidden = Linear(c.eye_dim + c.emo_dim + D + c.style_dim, D)
        set_compute_dtype(self, dtype)

    @classmethod
    def random_init(cls, cfg: Optional[FaceFormerConfig] = None, seed: int = 0,
                    device=None, dtype: torch.dtype = torch.float32) -> "FaceFormerCoeff":
        """Seeded random weights from one CPU generator, with the JAX
        module's zero inits (``vertice_map_r``, ``obj_embedding``), so the
        fresh model emits zeros; the same weights at any compute ``dtype``.
        ``device=None`` means CUDA."""
        model = random_module(lambda: cls(cfg or FaceFormerConfig(), dtype),
                              resolve_device(device), torch.Generator().manual_seed(seed))
        with torch.no_grad():
            for p in (model.vertice_map_r.weight, model.obj_embedding):
                p.zero_()
        return model

    def encode_audio(self, audio: torch.Tensor, frame_num: int) -> torch.Tensor:
        """(B, samples) normalised audio -> (B, frame_num, D) memory."""
        return self.audio_feature_map(self.audio_encoder(audio, output_len=frame_num))

    def merge_condition(self, hidden_audio, eye_embed, emo_embed, ref_coeff) -> torch.Tensor:
        """hidden_audio (B, T, D), eye (B, T, 6), emo (B, T, 30), ref_coeff
        (B, 1, vertice_dim) -> (B, T, D)."""
        ref_style = self.coeff2style(ref_coeff)
        ref_style = ref_style.expand(*hidden_audio.shape[:2], ref_style.shape[-1])
        return self.v_merge2hidden(torch.cat([eye_embed, emo_embed, hidden_audio, ref_style], -1))

    def _memory(self, audio, frame_num, eye_embed, emo_embed, ref_coeff) -> torch.Tensor:
        memory = self.encode_audio(audio, frame_num)
        if self.cfg.with_condition_merge and eye_embed is not None:
            memory = self.merge_condition(memory, eye_embed, emo_embed, ref_coeff)
        return memory

    def forward(
        self,
        audio: torch.Tensor,  # (B, samples) normalised
        coeffs: torch.Tensor,  # (B, T, vertice_dim) normalised targets
        eye_embed: Optional[torch.Tensor] = None,
        emo_embed: Optional[torch.Tensor] = None,
        ref_coeff: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Teacher-forced: (B, T, vertice_dim)."""
        c = self.cfg
        T = coeffs.shape[1]
        memory = self._memory(audio, T, eye_embed, emo_embed, ref_coeff)
        shifted = torch.cat([torch.zeros_like(coeffs[:, :1]), coeffs[:, :-1]], dim=1)
        x = self.vertice_map(shifted)
        x = x + periodic_positional_encoding(T, c.feature_dim, c.period, x.dtype, x.device)[None]
        tgt_bias = faceformer_bias(c.nhead, T, c.period, device=x.device)
        mem_bias = enc_dec_alignment_bias(T, T, 1, device=x.device)
        return self.vertice_map_r(self.transformer_decoder(x, memory, tgt_bias, mem_bias))

    def predict(
        self,
        audio: torch.Tensor,  # (B, samples)
        frame_num: int,
        eye_embed: Optional[torch.Tensor] = None,
        emo_embed: Optional[torch.Tensor] = None,
        ref_coeff: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(B, frame_num, vertice_dim) by the KV-cached AR decode: step 0's
        token is ``obj_embedding``, later tokens ``vertice_map`` of the
        previous output, each with the positional encoding of its frame."""
        c = self.cfg
        if c.num_decoder_layers != 1:
            raise ValueError("the KV-cached decode is built for one decoder layer")
        with torch.no_grad():
            memory = self._memory(audio, frame_num, eye_embed, emo_embed, ref_coeff)
        token0 = self.obj_embedding.to(memory.dtype).expand(memory.shape[0], c.feature_dim)
        return ar_decode(self.transformer_decoder.layers[0], memory, token0,
                         out_proj=self.vertice_map_r, feedback_proj=self.vertice_map,
                         n_heads=c.nhead, period=c.period)
