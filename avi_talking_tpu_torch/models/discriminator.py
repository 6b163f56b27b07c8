"""PD-FGC's discriminator family: PatchGAN, multiscale and feature
discriminators (port of ``avi_talking_tpu/models/discriminator.py``, NCHW).

- ``NLayerDiscriminator``: the SPADE PatchGAN, k4 pad-2 convs, spectral
  norm + instance norm ("spectralinstance"), LeakyReLU(0.2); returns the
  per-stage features with the input first.
- ``MultiscaleDiscriminator``: ``num_d`` of them over an average-pool
  pyramid (k3 s2 p1, padding not counted).
- ``ImageDiscriminator``: the pix2pix PatchGAN (k4 pad 1, BatchNorm).
- ``FeatureDiscriminator``: dropout + a 512 -> labels linear.

Parameter names are the reference's (``model0.0``, ``model{n}.0.0.
weight_orig / weight_u / weight_v``, ``model.{i}``), so a reference state
dict loads with ``load_state_dict``; the ``*_state_from_torch`` functions
take one out of a larger dict by prefix and check it.

Spectral norm is JAX's ``SpectralConv``: sigma = u^T W v with the stored u
and v (normalised ones vectors at init), differentiated through W, u and
v; one power iteration updates u and v only when ``update_stats=True``,
which no trainer passes. JAX's discriminator step differentiates the whole
variables, its ``spectral`` collection included, so optax moves u and v
as it moves the weights: here they are parameters, under the reference's
names. ``torch.nn.utils.spectral_norm`` iterates on every training forward
and detaches u and v, so it is not used.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..infra.device import resolve_device
from ..infra.init import random_module


def _l2n(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v), min=eps)


class SpectralConv(nn.Module):
    """Conv2d with spectral weight normalisation: ``weight_orig`` reshaped
    to (out, in * kh * kw) is W, and the kernel used is W / (u^T W v), u
    (``weight_u``) and v (``weight_v``) trainable as in JAX's step."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 4, stride: int = 1,
                 padding: int = 2, use_bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        k = kernel_size
        self.weight_orig = nn.Parameter(torch.empty(features, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.weight_u = nn.Parameter(torch.empty(features))
        self.weight_v = nn.Parameter(torch.empty(in_ch * k * k))
        self.init_own_()

    def init_own_(self) -> None:
        with torch.no_grad():
            self.weight_u.copy_(_l2n(torch.ones_like(self.weight_u)))
            self.weight_v.copy_(_l2n(torch.ones_like(self.weight_v)))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        wmat = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        if update_stats:
            v = _l2n(wmat.t() @ u)
            u = _l2n(wmat @ v)
            with torch.no_grad():
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        sigma = u @ (wmat @ v)
        return F.conv2d(x, (self.weight_orig / sigma).to(x.dtype), self.bias, self.stride,
                        self.padding)


def instance_norm_2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) over the spatial dims."""
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mu) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


class NLayerDiscriminator(nn.Module):
    """The SPADE PatchGAN. ``norm``: 'spectralinstance' (upstream's
    default), 'spectral', 'instance' or 'none'. Returns [input, feat_0, ...,
    logits] with ``get_features``, else the logits."""

    def __init__(self, ndf: int = 64, n_layers: int = 4, norm: str = "spectralinstance",
                 get_features: bool = True, input_nc: int = 3):
        super().__init__()
        self.n_layers, self.get_features = n_layers, get_features
        self.spectral = norm.startswith("spectral")
        self.sub = norm[len("spectral"):] if self.spectral else norm
        if self.sub not in ("instance", "none", ""):
            raise ValueError(norm)
        use_bias = self.sub in ("none", "")  # the bias goes where a norm follows
        nf = ndf
        self.model0 = nn.Sequential(nn.Conv2d(input_nc, nf, 4, 2, 2), nn.LeakyReLU(0.2))
        for n in range(1, n_layers):
            prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == n_layers - 1 else 2
            conv = (SpectralConv(prev, nf, 4, stride, 2, use_bias) if self.spectral
                    else nn.Conv2d(prev, nf, 4, stride, 2, bias=use_bias))
            self.add_module(f"model{n}", nn.Sequential(nn.Sequential(conv), nn.LeakyReLU(0.2)))
        self.add_module(f"model{n_layers}", nn.Sequential(nn.Conv2d(nf, 1, 4, 1, 2)))

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        feats: List[torch.Tensor] = [x]
        h = self.model0(x)
        feats.append(h)
        for n in range(1, self.n_layers):
            block = getattr(self, f"model{n}")
            conv = block[0][0]
            h = conv(h, update_stats) if self.spectral else conv(h)
            if self.sub == "instance":
                h = instance_norm_2d(h)
            h = block[1](h)
            feats.append(h)
        h = getattr(self, f"model{self.n_layers}")(h)
        feats.append(h)
        return feats if self.get_features else h


def avg_pool_no_pad_count(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)


class MultiscaleDiscriminator(nn.Module):
    """``num_d`` NLayer PatchGANs over an average-pooled pyramid; a list
    (one a scale) of their outputs."""

    def __init__(self, num_d: int = 2, ndf: int = 64, n_layers: int = 4,
                 norm: str = "spectralinstance", get_features: bool = True, input_nc: int = 3):
        super().__init__()
        self.num_d = num_d
        for i in range(num_d):
            self.add_module(f"discriminator_{i}", NLayerDiscriminator(
                ndf, n_layers, norm, get_features, input_nc))

    @classmethod
    def random_init(cls, seed: int = 0, device=None, **kw) -> "MultiscaleDiscriminator":
        """Seeded random weights (u, v at their normalised ones), in train
        mode. ``device=None`` means CUDA."""
        return random_module(lambda: cls(**kw), resolve_device(device),
                             torch.Generator().manual_seed(seed)).train()

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        out = []
        for i in range(self.num_d):
            out.append(getattr(self, f"discriminator_{i}")(x, update_stats))
            if i + 1 < self.num_d:
                x = avg_pool_no_pad_count(x)
        return out


class _BatchNorm2d(nn.BatchNorm2d):
    """flax's ``BatchNorm(momentum=0.9)``: with ``train`` the batch's
    biased statistics normalise and update the running ones; without, the
    running ones normalise."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        shape = (1, -1, 1, 1)
        mul = (torch.rsqrt(var + self.eps) * self.weight).reshape(shape)
        return (x - mean.reshape(shape)) * mul + self.bias.reshape(shape)


class ImageDiscriminator(nn.Module):
    """The pix2pix PatchGAN: k4 p1 convs, BatchNorm, a 1-channel logit map;
    ``model.{i}`` as the reference's Sequential indices."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        layers: List[nn.Module] = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        prev = ndf
        for n in range(1, n_layers + 1):
            ch = ndf * min(2 ** n, 8)
            layers += [nn.Conv2d(prev, ch, 4, 2 if n < n_layers else 1, 1, bias=False),
                       _BatchNorm2d(ch, eps=1e-5), nn.LeakyReLU(0.2)]
            prev = ch
        layers.append(nn.Conv2d(prev, 1, 4, 1, 1))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for layer in self.model:
            x = layer(x, train) if isinstance(layer, _BatchNorm2d) else layer(x)
        return x


class FeatureDiscriminator(nn.Module):
    """512-d feature -> label logits, with dropout 0.5 when ``train`` (the
    keep mask drawn from ``generator``)."""

    def __init__(self, num_labels: int):
        super().__init__()
        self.fc = nn.Linear(512, num_labels)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.reshape(-1, 512)
        if train:
            if generator is None:
                raise ValueError("a dropout generator is needed when train=True")
            keep = torch.rand(x.shape, generator=generator).to(x.device) < 0.5
            x = torch.where(keep, x / 0.5, torch.zeros_like(x))
        return self.fc(x)


# --- reference state dicts -------------------------------------------------


def _take(sd: Mapping[str, Any], want: Dict[str, torch.Tensor],
          prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    for k, ref in want.items():
        if prefix + k not in sd:
            raise KeyError(f"discriminator state dict has no {prefix + k!r}")
        v = torch.as_tensor(sd[prefix + k])
        if tuple(v.shape) != tuple(ref.shape):
            raise ValueError(f"{prefix + k}: shape {tuple(v.shape)}, not {tuple(ref.shape)}")
        out[k] = v.to(ref.dtype)
    return out


def _meta_state(factory) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        return factory().state_dict()


def _in_nc(sd: Mapping[str, Any], key: str) -> int:
    return int(torch.as_tensor(sd[key]).shape[1])


def nlayer_state_from_torch(sd: Mapping[str, Any], n_layers: int = 4, prefix: str = "",
                            norm: str = "spectralinstance", ndf: Optional[int] = None
                            ) -> Dict[str, torch.Tensor]:
    """A reference NLayerDiscriminator (under ``prefix``) -> this module's
    state (JAX's ``nlayer_params_from_torch``; the stored u, v kept)."""
    w0 = torch.as_tensor(sd[f"{prefix}model0.0.weight"])
    want = _meta_state(lambda: NLayerDiscriminator(ndf or int(w0.shape[0]), n_layers, norm,
                                                   input_nc=int(w0.shape[1])))
    return _take(sd, want, prefix)


def multiscale_state_from_torch(sd: Mapping[str, Any], num_d: int = 2, n_layers: int = 4,
                                prefix: str = "", norm: str = "spectralinstance"
                                ) -> Dict[str, torch.Tensor]:
    out = {}
    for i in range(num_d):
        sub = nlayer_state_from_torch(sd, n_layers, f"{prefix}discriminator_{i}.", norm)
        out.update({f"discriminator_{i}.{k}": v for k, v in sub.items()})
    return out


def image_discriminator_state_from_torch(sd: Mapping[str, Any], n_layers: int = 3,
                                         prefix: str = "model.") -> Dict[str, torch.Tensor]:
    """A reference ImageDiscriminator's Sequential (under ``prefix``) ->
    this module's state, the BatchNorms' running statistics included."""
    w0 = torch.as_tensor(sd[f"{prefix}0.weight"])
    want = _meta_state(lambda: ImageDiscriminator(int(w0.shape[1]), int(w0.shape[0]), n_layers))
    want = {k: v for k, v in want.items() if not k.endswith("num_batches_tracked")}
    out = {f"model.{k}": v
           for k, v in _take(sd, {k[len("model."):]: v for k, v in want.items()}, prefix).items()}
    for k in [k for k in out if k.endswith("running_var")]:
        out[k[:-len("running_var")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return out
