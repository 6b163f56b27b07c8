"""EMOTE talking-head training step (port of
``avi_talking_tpu/train/talking_head.py``).

The geometric loss is the JAX trainer's ``_geometric_losses``: exp and jaw
MSE, their velocity terms (weight 10), and the vertex MSE when the head has
FLAME assets and the batch carries ``gt_vertices``; with a ``frame_mask``
(B, T) the means run over valid frames and a velocity term needs both
endpoints valid. ``disentangle="condition_exchange"`` doubles the batch
with the style conditions exchanged across a derangement; the geometric
losses read the first half.

``neural=NeuralLosses(...)`` adds the frozen perceptual terms over
differentiable renders (``NeuralLosses.loss``, JAX's ``_neural_losses``):
lip reading on mouth crops, EmoNet features per frame, a video-level
emotion classifier, each with its condition-exchange twin. A batch
without ``gt_vertices`` has them decoded from ``gt_exp`` / ``gt_jaw`` AFTER
the geometric losses, as JAX does, so a synthetic batch gets no vertex
term. The towers are frozen (no grad, ``eval()``, outside
``emote_trainables``) but the gradient runs through them into the rendered
pixels, through the winner's interpolation (K2 is the stop-gradient
visibility on the card) into the head.

JAX runs the head with ``deterministic=True`` and hands the whole
variables tree to ``optax.adamw``: so the head stays in ``eval()`` mode
(no dropout; BatchNorm reads its running statistics), and
``emote_trainables`` gives the optimizer every parameter plus the FLINT /
squasher BatchNorm running statistics, which JAX's gradient reaches and
its AdamW moves like weights. The gradient runs through wav2vec2's K1
(the CUDA kernel on the card) and its recompute backward.

A head at a bfloat16 compute dtype (``train-emote --bf16``) trains as
JAX's does: exp / jaw come out in bfloat16 and the geometric terms
promote them to the float32 targets; the FLAME decode, the gt decode and
the render run in float32 (K2 unchanged); each tower casts the float32
frames to its own compute dtype, and its terms are computed in it (JAX's
``jnp`` promotion, which torch's matches); the parameters, gradients and
AdamW state stay float32.

Under a ``mesh`` (``parallel.make_mesh``; JAX's ``jitted_train_step(mesh=)``)
each rank steps on its own rows of the global batch and the step is the
unsharded one: a rank's loss is its share, whose mean over the dp ranks is
the global loss (the means over equal row blocks average; a masked mean
divides this rank's sum by the global mask count, one all-reduce), the
exchange's derangement is drawn over the global batch and its conditions
and EmoNet targets are gathered over dp, and the gradients are averaged
over the dp group (by hand, or by FSDP2's reduce-scatter for the
parameters it shards; ``parallel.fsdp_shard_params``). The wav2vec2
encoder may be split over tp (``parallel.shard_params``); its
tp-replicated weights get the whole gradient on every tp rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.flame import FlameModel
from ..models.conditioning import StyleCondition
from ..models.emoca import EmoNetLoss
from ..models.emote import EmoteTalkingHead
from ..models.flint import RunningStatsBatchNorm1d
from ..models.lipread import LipReadingLoss, mouth_transform
from ..models.video_emotion import VideoEmotionLoss
from ..parallel.mesh import dp_gather, dp_mean, dp_size, dp_sum, reduce_gradients
from ..viz.visualizer import FixedViewRenderer
from .eval_metrics import condition_exchange


@dataclasses.dataclass
class NeuralLosses:
    """Frozen perceptual losses over differentiable renders of the front
    view (``renderer.render_torch(..., 0)``). Each tower is optional and is
    frozen here: ``requires_grad_(False)`` and ``eval()``."""

    renderer: FixedViewRenderer
    lipread: Optional[LipReadingLoss] = None
    lipread_weight: float = 0.0
    emonet: Optional[EmoNetLoss] = None
    emotion_weight: float = 0.0
    # frame features come from the EmoNet tower (emo_feat_2)
    video_emotion: Optional[VideoEmotionLoss] = None
    video_emotion_weight: float = 0.0

    def __post_init__(self):
        for tower in (self.lipread and self.lipread.net, self.emonet and self.emonet.module,
                      self.video_emotion and self.video_emotion.classifier):
            if tower is not None:
                tower.requires_grad_(False).eval()

    def any_enabled(self) -> bool:
        return ((self.lipread is not None and self.lipread_weight > 0)
                or (self.emonet is not None and self.emotion_weight > 0)
                or (self.video_emotion is not None and self.video_emotion_weight > 0))

    def render_video(self, vertices: torch.Tensor) -> torch.Tensor:
        """(B, T, V, 3) -> (B, T, H, W, 3), all B*T frames in one render."""
        B, T = vertices.shape[:2]
        video = self.renderer.render_torch(vertices.reshape(B * T, *vertices.shape[2:]), 0)
        return video.reshape(B, T, *video.shape[1:])

    def mouth_crops(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) -> lip-reading-normalised grey mouth patches."""
        return mouth_transform(self.renderer.crop_mouth(video).mean(dim=-1))

    def emo_outputs(self, video: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, T, H, W, 3) frames in [0, 1] -> EmoNet outputs, each (B, T,
        ...): one tower pass per distinct video set."""
        B, T = video.shape[:2]
        out = self.emonet.module(video.reshape(B * T, *video.shape[2:]).permute(0, 3, 1, 2))
        return {k: v.reshape(B, T, *v.shape[1:]) for k, v in out.items()}

    def loss(self, vertices: torch.Tensor, gt_vertices: torch.Tensor, batch, B_orig: int,
             perm: Optional[torch.Tensor], metrics: Dict[str, torch.Tensor], mesh=None
             ) -> torch.Tensor:
        """The perceptual terms of predicted ``vertices`` (B or 2B, T, V, 3)
        against ``gt_vertices`` (B, T, V, 3). With an exchange ``perm`` the
        rows B_orig: are the exchanged half: its lip reading is held to the
        ORIGINAL gt rows (keep the articulation), its emotion to the gt rows
        ``perm`` (carry the borrowed emotion), its video emotion to the
        labels ``perm``. The EmoNet tower runs once over all predicted rows
        and once over the gt rows; the twins permute features, not videos.
        The gt side runs without grad. Under a ``mesh`` the rows are this
        rank's, ``perm`` holds global row indices (the gt EmoNet outputs and
        labels are gathered over dp for it), and the terms are this rank's
        shares (``TalkingHeadTrainer``)."""
        pred_video = self.render_video(vertices)
        with torch.no_grad():
            gt_video = self.render_video(gt_vertices[:B_orig])
        return self.video_loss(pred_video, gt_video, batch, B_orig, perm, metrics, mesh)

    def video_loss(self, pred_video: torch.Tensor, gt_video: torch.Tensor, batch, B_orig: int,
                   perm: Optional[torch.Tensor], metrics: Dict[str, torch.Tensor], mesh=None
                   ) -> torch.Tensor:
        """``loss`` from the rendered videos (B or 2B, T, H, W, 3) and (B, T,
        H, W, 3)."""
        loss = 0.0
        mask = batch.get("frame_mask")
        mask_sum = None
        if mask is not None:  # doubled by the exchange: the original rows
            mask = mask[:B_orig]
            if mesh is not None:  # the global count, this rank's share of the sum
                mask_sum = dp_sum(mask.float().sum(), mesh) / dp_size(mesh)

        if self.lipread is not None and self.lipread_weight > 0:
            fpred = self.lipread.features(self.mouth_crops(pred_video))
            with torch.no_grad():
                fgt = self.lipread.features(self.mouth_crops(gt_video))
            l_lip = self.lipread.from_features(fpred[:B_orig], fgt, mask=mask, mask_sum=mask_sum)
            loss = loss + self.lipread_weight * l_lip
            metrics["loss_lipread"] = l_lip
            if perm is not None:
                l_lip_d = self.lipread.from_features(fpred[B_orig:], fgt, mask=mask,
                                                     mask_sum=mask_sum)
                loss = loss + self.lipread_weight * l_lip_d
                metrics["loss_lipread_disentangled"] = l_lip_d

        need_emo = self.emonet is not None and self.emotion_weight > 0
        need_vemo = self.video_emotion is not None and self.video_emotion_weight > 0
        if need_emo or need_vemo:
            pred_out = self.emo_outputs(pred_video)
            with torch.no_grad():
                gt_out = self.emo_outputs(gt_video)

        if need_emo:
            l_emo, _ = self.emonet.from_outputs({k: v[:B_orig] for k, v in pred_out.items()},
                                                gt_out)
            loss = loss + self.emotion_weight * l_emo
            metrics["loss_emotion"] = l_emo
            if perm is not None:
                p = perm.to(pred_video.device)
                l_emo_d, _ = self.emonet.from_outputs(
                    {k: v[B_orig:] for k, v in pred_out.items()},
                    {k: dp_gather(v, mesh)[p] for k, v in gt_out.items()})
                loss = loss + self.emotion_weight * l_emo_d
                metrics["loss_emotion_disentangled"] = l_emo_d

        if need_vemo:
            gt_logits = batch.get("gt_emotion_video_logits")
            gt_label = batch.get("expression")
            if gt_label is not None and gt_label.dim() == 2:  # one-hot
                gt_label = gt_label.argmax(dim=-1)

            if gt_logits is not None:
                gt_logits = gt_logits[:B_orig]
            elif gt_label is not None:
                gt_label = gt_label[:B_orig]

            def vemo(feats, rows):  # the gt logits when given, else the labels
                if gt_logits is not None:
                    return self.video_emotion(feats, gt_logits=gt_logits[rows])
                return self.video_emotion(feats, gt_label=None if gt_label is None
                                          else gt_label[rows])

            feats = pred_out["emo_feat_2"]
            l_vemo = vemo(feats[:B_orig], slice(None))
            loss = loss + self.video_emotion_weight * l_vemo
            metrics["loss_video_emotion"] = l_vemo
            if perm is not None:  # the twin's targets are rows of the global batch
                if gt_logits is not None:
                    gt_logits = dp_gather(gt_logits, mesh)
                elif gt_label is not None:
                    gt_label = dp_gather(gt_label, mesh)
                l_vemo_d = vemo(feats[B_orig:], perm.to(feats.device))
                loss = loss + self.video_emotion_weight * l_vemo_d
                metrics["loss_video_emotion_disentangled"] = l_vemo_d
        return loss


def emote_trainables(head: EmoteTalkingHead) -> List[torch.Tensor]:
    """What JAX's optax.adamw over the head's variables trains: every
    parameter, then the running mean and variance of each BatchNorm, which
    are set to require grad here (BatchNorm's step counter is not a JAX
    variable and stays out)."""
    stats = []
    for mod in head.modules():
        if isinstance(mod, RunningStatsBatchNorm1d):
            stats += [mod.running_mean.requires_grad_(), mod.running_var.requires_grad_()]
    return list(head.parameters()) + stats


def _mmean(err: torch.Tensor, w: Optional[torch.Tensor], mesh=None) -> torch.Tensor:
    """Mean of ``err`` (B, T, C), over the frames that weight ``w`` (B, T, 1)
    keeps when given; under a ``mesh`` this rank's share of the global mean
    (its weighted sum over the global weight, times dp)."""
    if w is None:
        return err.mean()
    if mesh is None:
        return (err * w).sum() / (w.sum() * err.shape[-1] + 1e-8)
    return (err * w).sum() * dp_size(mesh) / (dp_sum(w.sum(), mesh) * err.shape[-1] + 1e-8)


@dataclasses.dataclass
class TalkingHeadTrainer:
    head: EmoteTalkingHead
    optimizer: torch.optim.Optimizer
    exp_weight: float = 1.0
    jaw_weight: float = 1.0
    vertex_weight: float = 1.0
    velocity_weight: float = 10.0
    neural: Optional[NeuralLosses] = None
    disentangle: Optional[str] = None  # None | "condition_exchange"
    mesh: Any = None  # a ("dp", "tp") DeviceMesh: dp over the batch

    def __post_init__(self):
        if self.disentangle not in (None, "condition_exchange"):
            raise ValueError(f"unknown disentangle mode {self.disentangle!r}")
        self.head.eval()

    def _geometric_losses(self, out, batch, B_eff: int, metrics: Dict[str, torch.Tensor]):
        loss = 0.0
        exp, jaw = out["exp"][:B_eff], out["jaw"][:B_eff]
        mask = batch.get("frame_mask")
        m = mv = None
        if mask is not None:
            m = mask[:B_eff, :, None].float()  # (B, T, 1), float32 as in JAX at any head dtype
            mv = m[:, 1:] * m[:, :-1]  # a velocity needs both endpoints
        if "gt_exp" in batch:
            gt = batch["gt_exp"][:B_eff]
            l_exp = _mmean((exp - gt) ** 2, m, self.mesh)
            l_expv = _mmean((exp.diff(dim=1) - gt.diff(dim=1)) ** 2, mv, self.mesh)
            loss = loss + self.exp_weight * l_exp + self.velocity_weight * l_expv
            metrics.update(loss_exp=l_exp, loss_exp_vel=l_expv)
        if "gt_jaw" in batch:
            gt = batch["gt_jaw"][:B_eff]
            l_jaw = _mmean((jaw - gt) ** 2, m, self.mesh)
            l_jawv = _mmean((jaw.diff(dim=1) - gt.diff(dim=1)) ** 2, mv, self.mesh)
            loss = loss + self.jaw_weight * l_jaw + self.velocity_weight * l_jawv
            metrics.update(loss_jaw=l_jaw, loss_jaw_vel=l_jawv)
        if "gt_vertices" in batch and "vertices" in out:
            err_v = (out["vertices"][:B_eff] - batch["gt_vertices"][:B_eff]) ** 2
            if m is None:
                l_v = err_v.mean()
            else:
                l_v = _mmean(err_v.flatten(2), m, self.mesh)
            loss = loss + self.vertex_weight * l_v
            metrics["loss_vertex"] = l_v
        return loss

    def loss_fn(self, batch: Dict[str, torch.Tensor], perm: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``perm`` (or a draw from ``generator``) is the exchange's
        permutation when ``disentangle`` is set; under a mesh ``batch`` is
        this rank's rows and ``perm`` is over the global batch."""
        B_orig = batch["raw_audio"].shape[0]
        if self.disentangle == "condition_exchange":
            batch, perm = condition_exchange(batch, perm=perm, generator=generator,
                                             mesh=self.mesh)
        cond = StyleCondition(batch["expression"], batch["intensity"], batch["identity"],
                              batch.get("shape"))
        valid_len = None
        if "frame_mask" in batch:  # padded real-data windows
            valid_len = batch["frame_mask"].sum(-1).to(torch.int32)
        out = self.head(batch["raw_audio"], condition=cond, gt_shape=batch.get("gt_shape"),
                        valid_len=valid_len)
        metrics: Dict[str, torch.Tensor] = {}
        loss = self._geometric_losses(out, batch, B_orig, metrics)
        if self.neural is not None and self.neural.any_enabled():
            if ("gt_vertices" not in batch and "gt_exp" in batch
                    and self.head.flame_assets is not None):
                batch = dict(batch, gt_vertices=self._decode_gt_vertices(batch, B_orig))
            if "vertices" not in out or "gt_vertices" not in batch:
                raise ValueError("the neural losses need FLAME vertices: build the head with "
                                 "flame_assets and give gt_vertices or gt_exp / gt_jaw")
            loss = loss + self.neural.loss(out["vertices"], batch["gt_vertices"], batch, B_orig,
                                           perm, metrics, self.mesh)
        metrics["loss"] = loss
        return loss, metrics

    @torch.no_grad()
    def _decode_gt_vertices(self, batch, B_orig: int) -> torch.Tensor:
        """(B, T, V, 3) FLAME vertices of the batch's gt_exp / gt_jaw (and
        gt_shape, else zero shape): the render target of a batch that
        carries coefficients, not meshes."""
        c = self.head.cfg
        ge, gj = batch["gt_exp"][:B_orig].float(), batch["gt_jaw"][:B_orig].float()
        Bv, Tv = ge.shape[:2]
        gs = batch.get("gt_shape")
        gs = ge.new_zeros(Bv, c.n_shape) if gs is None else gs[:B_orig].float()
        shape_bt = gs[:, None].expand(Bv, Tv, c.n_shape)
        pose = torch.cat([torch.zeros_like(gj), gj], dim=-1)
        flame = FlameModel(self.head.flame_assets, n_shape=c.n_shape, n_exp=c.flint.n_exp)
        return flame.vertices_only(shape_bt.reshape(Bv * Tv, -1), ge.reshape(Bv * Tv, -1),
                                   pose.reshape(Bv * Tv, -1)).reshape(Bv, Tv, -1, 3)

    def train_step(self, batch: Dict[str, torch.Tensor], perm: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step in place; returns the step's metrics (detached;
        under a mesh the global batch's)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss_fn(batch, perm, generator)
        loss.backward()
        reduce_gradients([p for g in self.optimizer.param_groups for p in g["params"]], self.mesh)
        self.optimizer.step()
        return dp_mean({k: v.detach() for k, v in metrics.items()}, self.mesh)

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor], perm: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        return dp_mean(self.loss_fn(batch, perm, generator)[1], self.mesh)
