"""EMOCA / DECA self-supervised training, the coarse and the detail stage
(port of ``avi_talking_tpu/train/emoca_trainer.py``).

The coarse step encodes images to DECA codes, decodes them through FLAME
and the weak-perspective camera, renders them textured and SH-lit
(``viz.shading.render_textured``, K2 on the card) and takes Adam
(``optax.adam``) on the coarse loss set of ``train.deca_losses``. The
encoders' BatchNorms read their running statistics, which stay frozen, as
in JAX. ``train_exp_only`` is EMOCA's staging: DECA's coarse tower
``E_flame`` takes no update (JAX zeroes its updates with
``optax.set_to_zero``) and only ``E_expression`` trains.

The detail step (``DecaDetailTrainer``) trains ``E_detail`` and the
detail generator on a frozen coarse pipeline. JAX hands the generator's
whole variables to Adam, so its BatchNorm running statistics train like
weights (``DetailGenerator.trainables``); ``E_detail``'s stay frozen. The
coarse codes take no gradient in JAX, so the UV unwraps (``world2uv``) run
under ``torch.no_grad`` here: autograd would otherwise keep every dense
chunk of them.

Images in a batch are NHWC in [0, 1], as in JAX; the towers take NCHW.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from ..core.flame import FlameModel, FlameTex
from ..core.projection import batch_orth_proj
from ..models.deca_detail import DecaDetailModel, world2uv
from ..models.emoca import EmocaEncoder, EmoNetLoss, split_deca_code
from ..viz.rasterizer import compute_vertex_normals
from ..viz.shading import add_sh_light, render_detailed, render_textured, sample_nhwc
from .deca_losses import (DecaLossWeights, IDMRFLoss, coarse_losses, detail_patch_losses,
                          photometric_loss, resize_bilinear, shading_smooth_loss, z_reg,
                          z_symmetry_loss)
from .optim import adam


def _project(flame: FlameModel, shape, exp, pose, cam):
    """FLAME, then DECA's batch_orth_proj with the y / z flip -> (verts,
    NDC verts, 2-D landmarks in NDC)."""
    verts, lmk2d, _ = flame(shape, exp, pose)
    trans = batch_orth_proj(verts, cam)
    ndc = torch.stack([trans[..., 0], -trans[..., 1], -trans[..., 2]], dim=-1)
    plmk = batch_orth_proj(lmk2d, cam)[..., :2]
    return verts, ndc, torch.stack([plmk[..., 0], -plmk[..., 1]], dim=-1)


def _albedo(flame_tex: Optional[FlameTex], tex: torch.Tensor) -> torch.Tensor:
    """The PCA albedo, or flat grey (B, 8, 8, 3) without a texture model."""
    if flame_tex is not None:
        return flame_tex(tex)
    return tex.new_full((tex.shape[0], 8, 8, 3), 0.6)


def _nchw(images: torch.Tensor) -> torch.Tensor:
    return images.permute(0, 3, 1, 2)


@dataclasses.dataclass
class EmocaTrainer:
    """The frozen geometry and render around the trainable ``EmocaEncoder``."""

    encoder: EmocaEncoder
    flame: FlameModel
    uv_coords: torch.Tensor  # (Tv, 2)
    uv_faces: torch.Tensor  # (F, 3)
    flame_tex: Optional[FlameTex] = None  # PCA albedo; None: flat grey
    image_size: int = 224
    weights: DecaLossWeights = dataclasses.field(default_factory=DecaLossWeights)
    train_exp_only: bool = False
    raster_chunk: int = 2048
    # EMOCA's emotion consistency between the input and the render through
    # a frozen EmoNet, gated by weights.emonet
    emonet: Optional[EmoNetLoss] = None

    def decode(self, codes: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        shape = codes["shape"][:, :self.flame.n_shape]
        exp = codes["exp"][:, :self.flame.n_exp]
        pose, cam = codes["pose"], codes["cam"]
        verts, ndc, plmk = _project(self.flame, shape, exp, pose, cam)
        light = codes["light"].reshape(codes["light"].shape[0], 9, 3)
        albedo = _albedo(self.flame_tex, codes["tex"])
        imgs, aux = render_textured(ndc, self.flame.assets.faces, self.uv_coords, self.uv_faces,
                                    albedo, self.image_size, self.image_size, sh_coeff=light,
                                    chunk=self.raster_chunk, return_aux=True)
        return {"verts": verts, "trans_verts": ndc, "predicted_landmarks": plmk,
                "predicted_images": imgs, "shading": aux["shading"], "albedo": albedo,
                "alpha": aux["alpha_images"], "shapecode": shape, "expcode": exp,
                "texcode": codes["tex"], "lightcode": light, "posecode": pose}

    def loss_fn(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: images (B, H, W, 3) in [0, 1], lmk (B, 68, 2) in NDC, and
        optionally masks (B, H, W, 1) (the render alpha where absent)."""
        images = batch["images"]
        codedict = self.decode(self.encoder(_nchw(images)))
        masks = batch.get("masks")
        if masks is None:  # no segmentation: compare inside the render's coverage
            masks = codedict["alpha"][..., None].to(images.dtype)
        codedict.update(images=images, lmk=batch["lmk"], masks=masks)
        terms = coarse_losses(codedict, self.weights)
        if self.emonet is not None and self.weights.emonet:
            emo, _ = self.emonet(_nchw(codedict["predicted_images"]), _nchw(images))
            terms["emotion"] = emo * self.weights.emonet
        return sum(terms.values()), terms

    def trainables(self) -> List[torch.Tensor]:
        """The encoder's parameters (only ``E_expression``'s under
        ``train_exp_only``); the frozen ones are set to take no gradient."""
        enc = self.encoder
        enc.E_flame.requires_grad_(not self.train_exp_only)
        towers = [enc.E_expression] if self.train_exp_only else [enc.E_flame, enc.E_expression]
        return [p for t in towers for p in t.parameters()]

    def make_optimizer(self, lr: float = 1e-4) -> torch.optim.Optimizer:
        return adam(self.trainables(), lr)

    def train_step(self, optimizer: torch.optim.Optimizer,
                   batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        total, terms = self.loss_fn(batch)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in dict(terms, total=total).items()}


@dataclasses.dataclass
class DecaDetailTrainer:
    """DECA / EMOCA's detail stage: masked photometric L1 on the detail
    render (photow 2), face-patch L1 (and IDMRF with ``use_idmrf``) between
    the detail-shaded UV texture and the UV-unwrapped input (sfsw [5, 0, 0],
    mrfwr 0.05), and the displacement terms z_reg / z_diff / z_sym (0.005
    each): default_detail_expdeca_emonet.yaml's weights."""

    encoder: EmocaEncoder  # with_detail=True
    detail_model: DecaDetailModel
    flame: FlameModel
    flame_tex: Optional[FlameTex] = None
    image_size: int = 224
    photow: float = 2.0
    sfsw: tuple = (5.0, 0.0, 0.0)
    mrfwr: float = 0.05
    zregw: float = 0.005
    zdiffw: float = 0.005
    zsymw: float = 0.005
    use_idmrf: bool = False
    vgg_apply: Optional[Callable] = None  # NCHW images -> {tap: feat} for IDMRF
    raster_chunk: int = 2048

    def loss_fn(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: images (B, H, W, 3) in [0, 1], optionally masks (B, H, W,
        1) (ones where absent)."""
        images = batch["images"]
        B = images.shape[0]
        dm, faces = self.detail_model, self.flame.assets.faces
        x = _nchw(images)
        with torch.no_grad():  # the frozen coarse pipeline
            codes = split_deca_code(self.encoder.E_flame(x))
            exp = self.encoder.E_expression(x)[:, :self.flame.n_exp]
            shape = codes["shape"][:, :self.flame.n_shape]
            pose, light = codes["pose"], codes["light"].reshape(B, 9, 3)
            verts, ndc, _ = _project(self.flame, shape, exp, pose, codes["cam"])
            albedo = _albedo(self.flame_tex, codes["tex"])
            # coarse UV geometry, and the UV unwraps of the image's geometry
            # and visibility (DECA.py:1115-1127), in one rasterization
            uv = world2uv(torch.stack([verts, compute_vertex_normals(verts, faces), ndc,
                                       compute_vertex_normals(ndc, faces)]),
                          faces, dm.uv_coords, dm.uv_faces, dm.uv_size)
        detail = self.encoder.E_detail(x)
        uv_detail_normals, uv_z = dm.decode(pose[:, 3:], exp, detail, verts,
                                            uv_geometry=(uv[0], uv[1]))
        uv_shading = add_sh_light(uv_detail_normals, light)
        S = uv_shading.shape[1]
        uv_texture = torch.clamp(resize_bilinear(albedo, S, S) * uv_shading / math.pi, 0.0, 1.0)
        pred = render_detailed(ndc, faces, dm.uv_coords, dm.uv_faces, albedo, uv_detail_normals,
                               self.image_size, self.image_size, sh_coeff=light,
                               chunk=self.raster_chunk)
        masks = batch.get("masks")
        if masks is None:
            masks = images.new_ones(*images.shape[:3], 1)
        with torch.no_grad():
            uv_gt = sample_nhwc(torch.cat([images, masks], dim=-1), uv[2][..., :2])
            uv_vis_mask = uv_gt[..., 3:] * (uv[3][..., 2:] < -0.05).to(images.dtype)
        terms = {
            "photometric_detailed": photometric_loss(pred, images, masks) * self.photow,
            "z_reg": z_reg(uv_z) * self.zregw,
            "z_diff": shading_smooth_loss(uv_shading) * self.zdiffw,
            "z_sym": z_symmetry_loss(uv_z, uv_vis_mask) * self.zsymw,
        }
        idmrf = IDMRFLoss() if self.use_idmrf and self.vgg_apply is not None else None
        terms.update(detail_patch_losses(
            uv_texture, uv_gt[..., :3], uv_vis_mask, sfsw=self.sfsw,
            patch_size=min(256, self.image_size), idmrf=idmrf, vgg_apply=self.vgg_apply,
            mrfwr=self.mrfwr))
        return sum(terms.values()), terms

    def trainables(self) -> List[torch.Tensor]:
        """``E_detail``'s parameters and the generator's, with its
        BatchNorm statistics; the coarse towers take no gradient."""
        self.encoder.E_flame.requires_grad_(False)
        self.encoder.E_expression.requires_grad_(False)
        return list(self.encoder.E_detail.parameters()) + self.detail_model.generator.trainables()

    def make_optimizer(self, lr: float = 1e-4) -> torch.optim.Optimizer:
        return adam(self.trainables(), lr)

    train_step = EmocaTrainer.train_step


def _print_coarse(step: int, vals: Dict[str, float]) -> None:
    print(f"step {step}: total={vals['total']:.4f} photo={vals.get('photometric', 0):.4f} "
          f"lmk={vals.get('landmark', 0):.4f}")


def train_emoca(trainer, batches: Iterator[Dict[str, torch.Tensor]], steps: int,
                lr: float = 1e-4, log_every: int = 50,
                log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None
                ) -> Dict[str, float]:
    """Adam over ``trainer.trainables()`` for ``steps`` steps (either
    stage); trains the trainer's modules in place and returns the last
    step's terms."""
    optimizer = trainer.make_optimizer(lr)
    terms: Dict[str, torch.Tensor] = {}
    for i in range(steps):
        terms = trainer.train_step(optimizer, next(batches))
        if log_every and (i + 1) % log_every == 0:
            (log_fn or _print_coarse)(i + 1, {k: float(v) for k, v in terms.items()})
    return {k: float(v) for k, v in terms.items()}
