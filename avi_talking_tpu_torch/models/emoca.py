"""EMOCA / DECA coefficient encoders and the EmoNet-style emotion module
(port of ``avi_talking_tpu/models/emoca.py``, NCHW).

* ``DecaEncoder`` (the reference's ResnetEncoder): ResNet-50 ->
  Linear(2048, 1024) -> ReLU -> Linear(1024, n), under the names
  ``encoder.*`` / ``layers.0`` / ``layers.2``; the DECA code layout is
  [shape 100 | tex 50 | exp 50 | pose 6 | cam 3 | light 27] = 236.
* ``EmocaEncoder``: DECA's coarse tower ``E_flame``, EMOCA's expression
  tower ``E_expression`` whose code replaces the exp block, and with
  ``with_detail`` DECA's ``E_detail`` (JAX: ``coarse``, ``expression``,
  ``detail``), so a reference EMOCA checkpoint loads by its own names.
* ``emoca_pseudo_gt``: the EmocaPreprocessor's per-clip targets.
* ``EmotionRecognitionModule`` (EmoCnnModule): ResNet-50 features ->
  expression logits (8) + valence + arousal; EMOTE's emotion loss compares
  the 2048-d features (``emo_feat_2``) by MSE.

``dtype`` is the compute dtype of the backbone and the head, as JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from ..infra.checkpoint import own_state
from ..ops.layers import Linear, set_compute_dtype
from .resnet import ResNet50

DECA_CODE_SPLITS = {"shape": 100, "tex": 50, "exp": 50, "pose": 6, "cam": 3, "light": 27}


def split_deca_code(code: torch.Tensor, splits=None) -> Dict[str, torch.Tensor]:
    out, i = {}, 0
    for k, n in (splits or DECA_CODE_SPLITS).items():
        out[k] = code[..., i:i + n]
        i += n
    return out


class DecaEncoder(nn.Module):
    """(B, 3, H, W) images in [0, 1] -> (B, outsize) code."""

    def __init__(self, outsize: int = 236, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = ResNet50()
        self.layers = nn.Sequential(Linear(2048, 1024), nn.ReLU(), Linear(1024, outsize))
        set_compute_dtype(self, dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.layers(self.encoder(images))


class EmocaEncoder(nn.Module):
    """(B, 3, H, W) images in [0, 1] -> {"shape", "tex", "exp", "pose",
    "cam", "light"} codes, "exp" from the expression tower (``n_exp``
    wide), and "detail" (``n_detail``) with ``with_detail``."""

    def __init__(self, n_exp: int = 50, with_detail: bool = False, n_detail: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.E_flame = DecaEncoder(236, dtype)
        self.E_expression = DecaEncoder(n_exp, dtype)
        self.E_detail = DecaEncoder(n_detail, dtype) if with_detail else None

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        codes = split_deca_code(self.E_flame(images))
        codes["exp"] = self.E_expression(images)
        if self.E_detail is not None:
            codes["detail"] = self.E_detail(images)
        return codes


def emoca_pseudo_gt(codes: Dict[str, torch.Tensor],
                    landmark_validity: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """EmocaPreprocessor's targets from per-frame codes (each (T, n)): the
    landmark-validity-weighted mean shape, the exp codes, the jaw pose (the
    global rotation dropped) and the first frame's texture code."""
    T = codes["shape"].shape[0]
    if landmark_validity is None:
        w = codes["shape"].new_full((T, 1), 1.0 / T)
    else:
        w = landmark_validity[:, None] / torch.clamp_min(landmark_validity.sum(), 1e-6)
    tex = codes["tex"] if "tex" in codes else codes["shape"].new_zeros(T, 50)
    return {"gt_shape": (codes["shape"] * w).sum(dim=0), "gt_exp": codes["exp"],
            "gt_jaw": codes["pose"][:, 3:], "gt_tex": tex[0]}


class EmotionRecognitionModule(nn.Module):
    """(N, 3, H, W) images -> {"emo_feat_2": (N, 2048), "expr_classification":
    (N, n_expression), and with ``predict_va`` "valence" / "arousal" (N,)}."""

    def __init__(self, n_expression: int = 8, predict_va: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_expression = n_expression
        self.predict_va = predict_va
        self.backbone = ResNet50()
        self.linear = Linear(2048, n_expression + (2 if predict_va else 0))
        set_compute_dtype(self, dtype)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        feat = self.backbone(images)
        pred = self.linear(feat)
        n = self.n_expression
        out = {"emo_feat_2": feat, "expr_classification": pred[..., :n]}
        if self.predict_va:
            out["valence"] = pred[..., n]
            out["arousal"] = pred[..., n + 1]
        return out


@dataclasses.dataclass
class EmoNetLoss:
    """create_emo_loss's defaults: MSE on ``emo_feat_2`` (plus valence /
    arousal terms when weighted)."""

    module: EmotionRecognitionModule
    feat_weight: float = 1.0
    valence_weight: float = 0.0
    arousal_weight: float = 0.0
    expression_weight: float = 0.0

    def __call__(self, pred_images: torch.Tensor, gt_images: torch.Tensor):
        with torch.no_grad():
            g = self.module(gt_images)
        return self.from_outputs(self.module(pred_images), g)

    def from_outputs(self, p, g):
        """Loss from tower outputs computed once per distinct video set
        (every term means over all batch dims); ``g`` is detached here."""
        g = {k: v.detach() for k, v in g.items()}
        loss = self.feat_weight * ((p["emo_feat_2"] - g["emo_feat_2"]) ** 2).mean()
        metrics = {"emo_feat": loss}
        for name, w in (("valence", self.valence_weight), ("arousal", self.arousal_weight)):
            if w and name in p:
                term = ((p[name] - g[name]) ** 2).mean()
                loss = loss + w * term
                metrics[name] = term
        return loss, metrics


# --- reference state dicts -------------------------------------------------


def deca_encoder_state_from_torch(sd: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A reference ResnetEncoder's state (``encoder.*``, ``layers.{0,2}.*``
    under ``prefix``) -> ``DecaEncoder``'s: its own keys, any other left
    out (``infra.checkpoint.own_state``); the code width is the file's."""
    with torch.device("meta"):
        want = DecaEncoder(int(torch.as_tensor(sd[f"{prefix}layers.2.weight"]).shape[0]))
    return own_state(want, sd, prefix)


def emoca_encoder_state_from_torch(sd: Mapping[str, Any], prefix: str = "",
                                   with_detail: bool = False) -> Dict[str, torch.Tensor]:
    """An EMOCA / DECA checkpoint -> ``EmocaEncoder``'s state: the towers
    ``E_flame.``, ``E_expression.`` and with ``with_detail`` ``E_detail.``
    under ``prefix``."""
    towers = ["E_flame.", "E_expression."] + (["E_detail."] if with_detail else [])
    out: Dict[str, torch.Tensor] = {}
    for t in towers:
        out.update({t + k: v for k, v in
                    deca_encoder_state_from_torch(sd, prefix + t).items()})
    return out
