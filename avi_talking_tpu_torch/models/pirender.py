"""PIRender: FLAME-coefficient-driven 2-D face reenactment (port of
``avi_talking_tpu/models/pirender.py``, NCHW).

The default config is the reference's ``flame_wo_crop.yaml``: a 59-d
coefficient window of 27 frames -> ``MappingNet`` (dilated 1-D convs) ->
256-d descriptor; ``WarpingNet`` (an AdaIN hourglass -> a 2-channel flow ->
a bilinear warp of the source image); ``EditingNet`` (a U-Net with AdaIN
residual blocks) -> the refined image in [-1, 1]. No spectral norm, as the
shipped config.

Parameter names and shapes are the reference ``net_G``'s
(``mapping_net.first.0``, ``warpping_net.hourglass.encoder.encoder{i}``,
``editing_net.decoder.res{i}.res{j}``, ``LayerNorm2d`` weights stored
(C, 1, 1)), so a reference state dict loads with ``load_state_dict`` after
``pirender_state_from_torch`` unwraps it. The coefficient window is
channels first, (B, C, 27), as the reference's ``driving_source``.

``dtype`` is the compute dtype, as in JAX (``ops/layers.py``): convs and
dense layers round their outputs to it; ``LayerNorm2d`` multiplies by its
float32 parameters, so its output is float32 and the next conv casts it
down; ``Adain`` stays in the compute dtype. The warp samples the float32
source with coordinates in the flow's dtype, as JAX's
``grid_sample_bilinear`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..infra.device import resolve_device
from ..infra.init import random_module
from ..ops.layers import (Conv1d, Conv2d, ConvTranspose2d, LeakyReLU, Linear, scalar,
                          set_compute_dtype)
from ..ops.resize import resize_bilinear


@dataclasses.dataclass(frozen=True)
class PIRenderConfig:
    coeff_nc: int = 59
    descriptor_nc: int = 256
    mapping_layers: int = 3
    image_nc: int = 3
    base_nc_warp: int = 32
    base_nc_edit: int = 64
    max_nc: int = 256
    encoder_layers: int = 5
    decoder_layers: int = 3
    editing_layers: int = 3
    num_res_blocks: int = 2

    @classmethod
    def tiny(cls) -> "PIRenderConfig":
        return cls(
            coeff_nc=9, descriptor_nc=32, mapping_layers=1, base_nc_warp=8,
            base_nc_edit=8, max_nc=32, encoder_layers=3, decoder_layers=2,
            editing_layers=2, num_res_blocks=1,
        )


def _act() -> nn.Module:
    return LeakyReLU(0.1)


_WIDE = (torch.float32, torch.float64)  # computed as they are, as torch's own ops do


def _normalize(x: torch.Tensor, dims) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + 1e-5)`` in ``x``'s dtype, the mean and the
    (two-pass) variance taken in float32 and rounded to it, as ``jnp.mean``
    / ``jnp.var`` compute them; the rsqrt in float32, rounded once (torch's
    bfloat16 rsqrt rounds the square root first)."""
    dt = x.dtype
    xf = x if dt in _WIDE else x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=dims, keepdim=True)
    if dt in _WIDE:
        return (x - mean) * torch.rsqrt(var + 1e-5)
    inv = torch.rsqrt((var.to(dt) + scalar(1e-5, dt)).float()).to(dt)
    return (x - mean.to(dt)) * inv


class LayerNorm2d(nn.Module):
    """``F.layer_norm`` over (C, H, W) with a per-channel affine stored
    (C, 1, 1). Below float32 the normalised value is rounded to the input's
    dtype, then promoted by the float32 affine (JAX's ``LayerNorm2d``)."""

    affine_norm = True

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, 1, 1))
        self.bias = nn.Parameter(torch.zeros(features, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype in _WIDE:
            shape = x.shape[1:]
            return F.layer_norm(x, shape, self.weight.expand(shape), self.bias.expand(shape),
                                1e-5)
        return _normalize(x, (1, 2, 3)) * self.weight + self.bias


class Adain(nn.Module):
    """Instance norm (no affine) scaled and shifted by the descriptor:
    ``norm(x) * (1 + gamma(z)) + beta(z)``, in the compute dtype."""

    def __init__(self, norm_nc: int, feature_nc: int):
        super().__init__()
        self.mlp_shared = nn.Sequential(Linear(feature_nc, 128), nn.ReLU())
        self.mlp_gamma = Linear(128, norm_nc)
        self.mlp_beta = Linear(128, norm_nc)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        normalized = _normalize(x, (2, 3))
        h = self.mlp_shared(z)
        gamma = self.mlp_gamma(h)[:, :, None, None]
        beta = self.mlp_beta(h)[:, :, None, None]
        return normalized * (1.0 + gamma) + beta


def _conv_t2x(in_nc: int, out_nc: int) -> ConvTranspose2d:
    """A 2x upsample: flax's ``ConvTranspose(3, 2, ((1, 2), (1, 2)),
    transpose_kernel=True)`` is torch's ``ConvTranspose2d(3, 2, 1, 1)``
    with the reference's kernel as it is."""
    return ConvTranspose2d(in_nc, out_nc, 3, stride=2, padding=1, output_padding=1)


class MappingNet(nn.Module):
    """(B, coeff_nc, 27) window -> (B, descriptor_nc): VALID convolutions
    over time, dilated residual layers on the centre ``[3:-3]``, then the
    mean over what is left."""

    def __init__(self, cfg: PIRenderConfig):
        super().__init__()
        self.layer = cfg.mapping_layers
        self.first = nn.Sequential(Conv1d(cfg.coeff_nc, cfg.descriptor_nc, 7))
        for i in range(cfg.mapping_layers):
            self.add_module(f"encoder{i}", nn.Sequential(
                _act(), Conv1d(cfg.descriptor_nc, cfg.descriptor_nc, 3, dilation=3)))

    def forward(self, coeff_window: torch.Tensor) -> torch.Tensor:
        x = self.first(coeff_window)
        for i in range(self.layer):
            x = getattr(self, f"encoder{i}")(x) + x[:, :, 3:-3]
        return x.mean(dim=-1)


class AdainEncoderBlock(nn.Module):
    def __init__(self, in_nc: int, out_nc: int, feature_nc: int):
        super().__init__()
        self.conv_0 = Conv2d(in_nc, out_nc, 4, 2, 1)
        self.conv_1 = Conv2d(out_nc, out_nc, 3, 1, 1)
        self.norm_0 = Adain(in_nc, feature_nc)
        self.norm_1 = Adain(out_nc, feature_nc)
        self.act = _act()

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_0(self.act(self.norm_0(x, z)))
        return self.conv_1(self.act(self.norm_1(x, z)))


class AdainDecoderBlock(nn.Module):
    def __init__(self, in_nc: int, out_nc: int, feature_nc: int):
        super().__init__()
        self.conv_0 = Conv2d(in_nc, out_nc, 3, 1, 1)
        self.conv_1 = _conv_t2x(out_nc, out_nc)
        self.conv_s = _conv_t2x(in_nc, out_nc)
        self.norm_0 = Adain(in_nc, feature_nc)
        self.norm_1 = Adain(out_nc, feature_nc)
        self.norm_s = Adain(in_nc, feature_nc)
        self.act = _act()

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        s = self.conv_s(self.act(self.norm_s(x, z)))
        h = self.conv_0(self.act(self.norm_0(x, z)))
        h = self.conv_1(self.act(self.norm_1(h, z)))
        return s + h


class _HourglassEncoder(nn.Module):
    def __init__(self, cfg: PIRenderConfig):
        super().__init__()
        ngf, img_f = cfg.base_nc_warp, cfg.max_nc
        self.layers = cfg.encoder_layers
        self.input_layer = Conv2d(cfg.image_nc, ngf, 7, 1, 3)
        for i in range(cfg.encoder_layers):
            self.add_module(f"encoder{i}", AdainEncoderBlock(
                min(ngf * 2 ** i, img_f), min(ngf * 2 ** (i + 1), img_f), cfg.descriptor_nc))

    def forward(self, x: torch.Tensor, z: torch.Tensor):
        x = self.input_layer(x)
        skips = [x]
        for i in range(self.layers):
            x = getattr(self, f"encoder{i}")(x, z)
            skips.append(x)
        return skips


class _HourglassDecoder(nn.Module):
    def __init__(self, cfg: PIRenderConfig):
        super().__init__()
        ngf, img_f, L = cfg.base_nc_warp, cfg.max_nc, cfg.encoder_layers
        self.order = list(range(L - cfg.decoder_layers, L))[::-1]
        for i in self.order:
            in_nc = min(ngf * 2 ** (i + 1), img_f)
            in_nc = in_nc * 2 if i != L - 1 else in_nc
            self.add_module(f"decoder{i}", AdainDecoderBlock(
                in_nc, min(ngf * 2 ** i, img_f), cfg.descriptor_nc))

    def forward(self, skips, z: torch.Tensor) -> torch.Tensor:
        out = skips.pop()
        for i in self.order:
            out = getattr(self, f"decoder{i}")(out, z)
            out = torch.cat([out, skips.pop()], dim=1)
        return out


class AdainHourglass(nn.Module):
    """The warping net's hourglass; its output has ``2 * min(base_nc_warp
    * 2**(encoder_layers - decoder_layers), max_nc)`` channels."""

    def __init__(self, cfg: PIRenderConfig):
        super().__init__()
        self.encoder = _HourglassEncoder(cfg)
        self.decoder = _HourglassDecoder(cfg)

    def forward(self, image: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(image, z), z)


def make_coordinate_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(h, w, 2) grid of (x, y) in [-1, 1], each op in ``dtype``."""
    x = 2 * (torch.arange(w, dtype=dtype, device=device) / (w - 1)) - 1
    y = 2 * (torch.arange(h, dtype=dtype, device=device) / (h - 1)) - 1
    return torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)], dim=-1)


def convert_flow_to_deformation(flow: torch.Tensor) -> torch.Tensor:
    """(B, 2, h, w) pixel flow -> (B, h, w, 2) normalised sampling grid."""
    _, _, h, w = flow.shape
    norm = torch.stack([flow[:, 0] / (w - 1), flow[:, 1] / (h - 1)], dim=-1) * 2
    return make_coordinate_grid(h, w, flow.dtype, flow.device)[None] + norm


def grid_sample_bilinear(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``F.grid_sample(align_corners=False, padding_mode="zeros")`` as JAX
    computes it: four gathers weighted by the fractional offsets, the
    coordinates in the grid's dtype. image (B, C, H, W); grid (B, Hg, Wg,
    2) of (x, y) in [-1, 1] -> (B, C, Hg, Wg)."""
    B, C, H, W = image.shape
    gx = (grid[..., 0] + 1) * W / 2 - 0.5
    gy = (grid[..., 1] + 1) * H / 2 - 0.5
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[:, None]
    wy = (gy - y0)[:, None]
    flat = image.reshape(B, C, H * W)

    def gather(ix, iy):
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = iy.clamp(0, H - 1).long() * W + ix.clamp(0, W - 1).long()
        vals = torch.gather(flat, 2, idx.reshape(B, 1, -1).expand(B, C, -1))
        return vals.reshape(B, C, *idx.shape[1:]) * valid[:, None]

    return (gather(x0, y0) * (1 - wx) * (1 - wy)
            + gather(x0 + 1, y0) * wx * (1 - wy)
            + gather(x0, y0 + 1) * (1 - wx) * wy
            + gather(x0 + 1, y0 + 1) * wx * wy)


class WarpingNet(nn.Module):
    def __init__(self, cfg: PIRenderConfig):
        super().__init__()
        self.hourglass = AdainHourglass(cfg)
        out_nc = min(cfg.base_nc_warp * 2 ** (cfg.encoder_layers - cfg.decoder_layers),
                     cfg.max_nc) * 2
        self.flow_out = nn.Sequential(LayerNorm2d(out_nc), _act(), Conv2d(out_nc, 2, 7, 1, 3))

    def forward(self, image: torch.Tensor, descriptor: torch.Tensor) -> Dict[str, torch.Tensor]:
        flow = self.flow_out(self.hourglass(image, descriptor))
        deformation = convert_flow_to_deformation(flow)
        # the flow is at the hourglass's output size: the deformation is
        # upsampled to the image's before sampling (flow_util.warp_image)
        if deformation.shape[1:3] != image.shape[2:]:
            deformation = resize_bilinear(deformation.permute(0, 3, 1, 2),
                                          tuple(image.shape[2:])).permute(0, 2, 3, 1)
        return {"flow_field": flow, "warp_image": grid_sample_bilinear(image, deformation),
                "deformation": deformation}


def _conv_ln(in_nc: int, out_nc: int, k: int, pool: bool = False) -> nn.Module:
    """The reference's ``model`` Sequential: conv, LayerNorm2d, act (and a
    2x2 average pool in the encoder's down blocks)."""
    holder = nn.Module()
    mods = [Conv2d(in_nc, out_nc, k, 1, k // 2), LayerNorm2d(out_nc), _act()]
    if pool:
        mods.append(nn.AvgPool2d(2))
    holder.model = nn.Sequential(*mods)
    return holder


class FineAdainResBlock(nn.Module):
    """``norm2(conv2(x)) + x``. The reference also computes ``act(norm1(
    conv1(x)))`` and discards it; its parameters are kept for the state
    dict, the computation is not."""

    def __init__(self, nc: int, feature_nc: int):
        super().__init__()
        self.conv1 = Conv2d(nc, nc, 3, 1, 1)
        self.conv2 = Conv2d(nc, nc, 3, 1, 1)
        self.norm1 = Adain(nc, feature_nc)
        self.norm2 = Adain(nc, feature_nc)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return self.norm2(self.conv2(x), z) + x


class EditingNet(nn.Module):
    def __init__(self, cfg: PIRenderConfig):
        super().__init__()
        ngf, img_f, L = cfg.base_nc_edit, cfg.max_nc, cfg.editing_layers
        self.L, self.res_blocks = L, cfg.num_res_blocks
        self.encoder = nn.Module()
        self.encoder.first = _conv_ln(cfg.image_nc * 2, ngf, 7)
        for i in range(L):
            self.encoder.add_module(f"down{i}", _conv_ln(
                min(ngf * 2 ** i, img_f), min(ngf * 2 ** (i + 1), img_f), 3, pool=True))
        self.decoder = nn.Module()
        for i in range(L):
            in_nc, out_nc = min(ngf * 2 ** (i + 1), img_f), min(ngf * 2 ** i, img_f)
            self.decoder.add_module(f"up{i}", _conv_ln(in_nc, out_nc, 3))
            res = nn.Module()
            for r in range(cfg.num_res_blocks):
                res.add_module(f"res{r}", FineAdainResBlock(in_nc, cfg.descriptor_nc))
            self.decoder.add_module(f"res{i}", res)
            self.decoder.add_module(f"jump{i}", _conv_ln(out_nc, out_nc, 3))
        self.decoder.final = nn.Module()
        self.decoder.final.model = nn.Sequential(Conv2d(ngf, cfg.image_nc, 7, 1, 3), nn.Tanh())

    def forward(self, input_image: torch.Tensor, warp_image: torch.Tensor,
                descriptor: torch.Tensor) -> torch.Tensor:
        x = self.encoder.first.model(torch.cat([input_image, warp_image], dim=1))
        skips = [x]
        for i in range(self.L):
            x = getattr(self.encoder, f"down{i}").model(x)
            skips.append(x)
        out = skips.pop()
        for i in reversed(range(self.L)):
            res = getattr(self.decoder, f"res{i}")
            for r in range(self.res_blocks):
                out = getattr(res, f"res{r}")(out, descriptor)
            up = getattr(self.decoder, f"up{i}").model(
                F.interpolate(out, scale_factor=2, mode="nearest"))
            out = up + getattr(self.decoder, f"jump{i}").model(skips.pop())
        return self.decoder.final.model(out)


class FaceGenerator(nn.Module):
    """MappingNet + WarpingNet + EditingNet. ``forward(input_image (B, 3,
    H, W) in [-1, 1], coeff_window (B, coeff_nc, 27), stage)`` ->
    ``{"flow_field", "warp_image", "deformation"}`` and, unless ``stage ==
    "warp"``, ``"fake_image"``."""

    def __init__(self, cfg: Optional[PIRenderConfig] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg = cfg or PIRenderConfig()
        self.mapping_net = MappingNet(cfg)
        self.warpping_net = WarpingNet(cfg)
        self.editing_net = EditingNet(cfg)
        set_compute_dtype(self, dtype)

    @classmethod
    def random_init(cls, cfg: Optional[PIRenderConfig] = None, seed: int = 0, device=None,
                    dtype: torch.dtype = torch.float32) -> "FaceGenerator":
        """Seeded random weights from one CPU generator (the same on any
        device). ``device=None`` means CUDA."""
        return random_module(lambda: cls(cfg, dtype), resolve_device(device),
                             torch.Generator().manual_seed(seed))

    def forward(self, input_image: torch.Tensor, coeff_window: torch.Tensor,
                stage: Optional[str] = None) -> Dict[str, torch.Tensor]:
        descriptor = self.mapping_net(coeff_window)
        out = self.warpping_net(input_image, descriptor)
        if stage != "warp":
            out["fake_image"] = self.editing_net(input_image, out["warp_image"], descriptor)
        return out


def pirender_state_from_torch(sd: Mapping[str, Any], cfg: PIRenderConfig) -> Dict[str, torch.Tensor]:
    """A reference ``net_G`` checkpoint -> this module's state dict: a
    trainer checkpoint's ``net_G_ema`` (else ``state_dict``) taken out, the
    ``module.`` prefix stripped, every key the config needs present with
    its shape (a ``KeyError`` / ``ValueError`` names the first that is
    not); other keys are left out. Counterpart of JAX's
    ``pirender_params_from_torch`` with the unwrap of ``cmd_portrait``."""
    if isinstance(sd, Mapping) and "net_G_ema" in sd:
        sd = sd["net_G_ema"]
    elif isinstance(sd, Mapping) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    with torch.device("meta"):
        want = FaceGenerator(cfg).state_dict()
    out = {}
    for k, ref in want.items():
        if k not in sd:
            raise KeyError(f"net_G state dict has no {k!r}")
        v = torch.as_tensor(sd[k]).float()
        if tuple(v.shape) != tuple(ref.shape):
            raise ValueError(f"net_G {k}: shape {tuple(v.shape)}, the config needs "
                             f"{tuple(ref.shape)}")
        out[k] = v
    return out
