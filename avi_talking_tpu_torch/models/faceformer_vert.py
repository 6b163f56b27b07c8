"""Stage-1 FaceFormer, vertex-space and disentanglement variant (port of
``avi_talking_tpu/models/faceformer_vert.py``).

* predicts vertex offsets from the FLAME template (tokens are offsets, the
  output adds the template back);
* one-hot subject style through a bias-free ``obj_vector``, used as the AR
  start token and added to every feedback token;
* conditioning: concat[learnable eye embed (6), emotion embed (30),
  audio (D)] -> ``v_merge2hidden`` (or the concatenation itself in
  ``concat_mode``);
* ``convert_coeff2verts``: de-normalised coefficients -> FLAME vertices with
  zero global pose;
* ``disentangle_losses``: cross-modal shuffle losses on eye / mouth region
  masks from template geometry thresholds (``FlameRegionSelector``).

The decoder layer runs K3 in its two attentions, as in ``faceformer.py``.
``dtype`` is flax's compute type, as there: the template, the default
one-hot subject and the eye embedding are built at it, and ``forward`` and
``predict`` return it (the float32 vertex offsets are cast by
``vertice_map``, as JAX's Dense casts them).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..audio.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from ..core.flame import FlameAssets, FlameModel
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


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass(frozen=True)
class FlameRegionSelector:
    """Vertex region masks (V,) bool from template geometry thresholds;
    eyeball vertices are left out of the eye region when a mask of them is
    given."""

    frontal: np.ndarray
    mouth: np.ndarray
    eye: np.ndarray

    @classmethod
    def from_template(
        cls,
        v_template,
        eyeball_mask=None,
        frontal_z: float = 0.035,
        face_y: float = 1.4,
        mouth_y_max: float = 1.5,
        eye_y_min: float = 1.49,
        eye_y_max: float = 1.57,
        eye_z: float = 0.030,
    ) -> "FlameRegionSelector":
        v = _np(v_template)
        frontal = (v[:, 2] > frontal_z) & (v[:, 1] > face_y)
        mouth = frontal & (v[:, 1] < mouth_y_max)
        eye = (v[:, 2] > eye_z) & (v[:, 1] > eye_y_min) & (v[:, 1] < eye_y_max)
        if eyeball_mask is not None:
            eye = eye & ~_np(eyeball_mask).astype(bool)
        return cls(frontal=frontal, mouth=mouth, eye=eye)

    @classmethod
    def from_assets(cls, assets: FlameAssets, eye_weight_thresh: float = 0.5,
                    **kw) -> "FlameRegionSelector":
        """Eyeballs from the LBS weights of the two eye joints (3 and 4)."""
        w = _np(assets.lbs_weights)
        eyeball = None
        if w.shape[1] >= 5:
            eyeball = (w[:, 3] > eye_weight_thresh) | (w[:, 4] > eye_weight_thresh)
        return cls.from_template(assets.v_template, eyeball, **kw)

    def unfold(self, name: str) -> np.ndarray:
        """(V,) -> (V*3,) per-coordinate mask."""
        m = getattr(self, name)
        return np.stack([m] * 3, axis=-1).reshape(-1)


@dataclasses.dataclass(frozen=True)
class FaceFormerVertConfig:
    vertice_dim: int = 15069  # 5023 * 3
    feature_dim: int = 64
    period: int = 30
    nhead: int = 4
    num_train_subjects: int = 1
    eye_dim: int = 6
    emo_dim: int = 30
    concat_mode: bool = False  # widen tokens by the eye + emo dims
    wav2vec2: Wav2Vec2Config = dataclasses.field(default_factory=Wav2Vec2Config)

    @property
    def d_model(self) -> int:
        return self.feature_dim + (self.eye_dim + self.emo_dim if self.concat_mode else 0)

    @classmethod
    def tiny(cls) -> "FaceFormerVertConfig":
        return cls(vertice_dim=30, feature_dim=32, period=5, wav2vec2=Wav2Vec2Config.tiny())


class FaceFormerVert(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, cfg: FaceFormerVertConfig, template: Optional[torch.Tensor] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.cfg = cfg
        d = c.d_model
        self.template = template  # (vertice_dim,) flattened, or None for zeros
        self.audio_encoder = Wav2Vec2Model(c.wav2vec2)
        self.audio_feature_map = Linear(c.wav2vec2.hidden_size, c.feature_dim)
        self.vertice_map = Linear(c.vertice_dim, d)
        self.vertice_map_r = Linear(d, c.vertice_dim)
        self.obj_vector = Linear(c.num_train_subjects, d, bias=False)
        self.learnable_eye_embed = nn.Parameter(torch.empty(c.eye_dim))
        if not c.concat_mode:
            self.v_merge2hidden = Linear(c.eye_dim + c.emo_dim + c.feature_dim, d)
        self.transformer_decoder = TransformerDecoder(1, d, c.nhead, d + c.feature_dim,
                                                      activation="relu")
        set_compute_dtype(self, dtype)

    @classmethod
    def random_init(cls, cfg: Optional[FaceFormerVertConfig] = None,
                    template: Optional[torch.Tensor] = None, seed: int = 0,
                    device=None, dtype: torch.dtype = torch.float32) -> "FaceFormerVert":
        """Seeded random weights from one CPU generator, with the JAX
        module's zero inits (``vertice_map_r``, ``learnable_eye_embed``);
        the same weights at any compute ``dtype``. ``device=None`` means
        CUDA."""
        device = resolve_device(device)
        model = random_module(lambda: cls(cfg or FaceFormerVertConfig(), dtype=dtype), device,
                              torch.Generator().manual_seed(seed))
        with torch.no_grad():
            for p in (model.vertice_map_r.weight, model.learnable_eye_embed):
                p.zero_()
        model.template = None if template is None else torch.as_tensor(template).to(device)
        return model

    def _template(self, device) -> torch.Tensor:
        if self.template is None:
            return torch.zeros(self.cfg.vertice_dim, dtype=self.compute_dtype, device=device)
        return self.template.reshape(-1).to(dtype=self.compute_dtype, device=device)

    def _style(self, one_hot: Optional[torch.Tensor], B: int, device) -> torch.Tensor:
        if one_hot is None:
            one_hot = torch.zeros(B, self.cfg.num_train_subjects, dtype=self.compute_dtype,
                                  device=device)
            one_hot[:, 0] = 1.0
        return self.obj_vector(one_hot)  # (B, d)

    def build_memory(self, audio: torch.Tensor, frame_num: int,
                     emo_embed: torch.Tensor) -> torch.Tensor:
        c, dt = self.cfg, self.compute_dtype
        hidden_a = self.audio_feature_map(self.audio_encoder(audio, output_len=frame_num))
        B, T = hidden_a.shape[:2]
        eye = self.learnable_eye_embed.to(dt)[None, None].expand(B, T, c.eye_dim)
        hidden = torch.cat([eye, emo_embed.to(dt), hidden_a], dim=-1)
        return hidden if c.concat_mode else self.v_merge2hidden(hidden)

    def forward(
        self,
        audio: torch.Tensor,
        gt_verts: torch.Tensor,  # (B, T, vertice_dim) absolute vertices
        emo_embed: torch.Tensor,  # (B, T, 30)
        one_hot: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Teacher-forced: absolute vertices (B, T, vertice_dim)."""
        c = self.cfg
        B, T = gt_verts.shape[:2]
        memory = self.build_memory(audio, T, emo_embed)
        style = self._style(one_hot, B, memory.device)[:, None]  # (B, 1, d)
        template = self._template(gt_verts.device)
        shifted = torch.cat([template[None, None].expand(B, 1, c.vertice_dim),
                             gt_verts[:, :-1]], dim=1)
        x = self.vertice_map(shifted - template[None, None]) + style
        x = x + periodic_positional_encoding(T, c.d_model, c.period, x.dtype, x.device)[None]
        tgt_bias = faceformer_bias(c.nhead, T, c.period, device=x.device)
        mem_bias = enc_dec_alignment_bias(T, T, 1, device=x.device)
        out = self.transformer_decoder(x, memory, tgt_bias, mem_bias)
        return self.vertice_map_r(out) + template[None, None]

    def predict(
        self,
        audio: torch.Tensor,
        frame_num: int,
        emo_embed: torch.Tensor,
        one_hot: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(B, frame_num, vertice_dim) absolute vertices by the KV-cached AR
        decode, with the subject style as start token and added to every
        feedback token."""
        c = self.cfg
        with torch.no_grad():
            memory = self.build_memory(audio, frame_num, emo_embed)
            style = self._style(one_hot, memory.shape[0], memory.device)
        outs = ar_decode(self.transformer_decoder.layers[0], memory, token0=style,
                         out_proj=self.vertice_map_r, feedback_proj=self.vertice_map,
                         n_heads=c.nhead, period=c.period, style_emb=style)
        return outs + self._template(outs.device)[None, None]


def convert_coeff2verts(
    flame: FlameModel,
    coeff_norm: torch.Tensor,  # (N, 53) normalised [exp50, jaw3]
    mean: torch.Tensor,
    std: torch.Tensor,
    shape_params: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """De-normalised coefficients -> FLAME vertices with zero global
    rotation. Returns (N, V*3)."""
    d = coeff_norm.shape[-1]
    coeff = coeff_norm * std[:d] + mean[:d]
    N = coeff.shape[0]
    ne = flame.n_exp
    if shape_params is None:
        shape_params = coeff.new_zeros(N, flame.n_shape)
    pose = torch.cat([coeff.new_zeros(N, 3), coeff[:, ne:ne + 3]], dim=1)
    return flame.vertices_only(shape_params, coeff[:, :ne], pose).reshape(N, -1)


def disentangle_losses(
    model: FaceFormerVert,
    audio: torch.Tensor,
    gt_verts: torch.Tensor,
    emo_embed: torch.Tensor,
    selector: FlameRegionSelector,
    generator: Optional[torch.Generator] = None,
    perms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Cross-modal shuffle losses: with the audio shuffled across the batch
    the eye region must still match (emotion drives it); with the emotion
    shuffled the mouth region must still match (audio drives it); plus the
    base vertex MSE. ``perms`` = (emotion permutation, audio permutation);
    without it both are drawn from ``generator``, in that order."""
    pred = model(audio, gt_verts, emo_embed)
    loss_verts = ((pred - gt_verts) ** 2).mean()
    if perms is None:
        perms = (torch.randperm(emo_embed.shape[0], generator=generator),
                 torch.randperm(audio.shape[0], generator=generator))
    perm_e, perm_a = (torch.as_tensor(p, device=audio.device).long() for p in perms)
    pred_shuf_emo = model(audio, gt_verts, emo_embed[perm_e])
    pred_shuf_aud = model(audio[perm_a], gt_verts, emo_embed)
    eye = torch.as_tensor(selector.unfold("eye"), dtype=gt_verts.dtype, device=gt_verts.device)
    mouth = torch.as_tensor(selector.unfold("mouth"), dtype=gt_verts.dtype, device=gt_verts.device)
    return {
        "verts": loss_verts,
        "verts_eye_area": (((pred_shuf_aud - gt_verts) * eye) ** 2).mean(),
        "verts_mouth_area": (((pred_shuf_emo - gt_verts) * mouth) ** 2).mean(),
    }
