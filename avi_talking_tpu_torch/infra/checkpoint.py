"""Checkpoints of the port, and the importers of the reference's prior.

A checkpoint is a directory, as the JAX drivers' orbax checkpoints are
(``<run>/checkpoints/best``, ``.../last``), holding one ``state.pt``: a
nested dict of ``state_dict``s, optimizer state, steps and losses, written
with ``torch.save`` and read with ``torch.load(weights_only=True)``. A
pipeline checkpoint (``AviTalkingPipeline.save``, the importers) holds the
parts ``clip``, ``brain``, ``prior`` and ``head``, or some of them.

The reference publishes torch ``.pth`` files; ``load_torch_state_dict``
reads one and ``import_prior_checkpoint`` maps the diffusion prior's into
the port's modules (port of ``avi_talking_tpu/infra/checkpoint.py``). The
port follows the reference's parameter names, so that is a prefix strip and
the feed-forward's two spellings. Orbax checkpoints of the JAX package are
not read.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import torch

FILE = "state.pt"


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Write ``state`` to ``path/state.pt``, replacing an earlier one whole
    (written beside it, then renamed)."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, FILE))


def restore_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    return torch.load(os.path.join(path, FILE), map_location=map_location, weights_only=True)


# --------- reference .pth importers --------------------------------------


def load_torch_state_dict(path: str) -> Mapping[str, Any]:
    """A torch checkpoint on the host: weights only first, the whole pickle
    when that refuses it (JAX's order); ``model_state_dict`` or
    ``state_dict`` unwrapped where the file nests one."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # an older pickle that weights_only refuses
        obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model_state_dict", "state_dict"):
        if isinstance(obj, dict) and key in obj:
            return obj[key]
    return obj


def own_state(module: torch.nn.Module, sd: Mapping[str, Any],
              prefix: str = "") -> Dict[str, torch.Tensor]:
    """``module``'s own keys out of ``sd`` (keys under ``prefix``), as the
    JAX importers read a reference file: every other key is left out, a
    BatchNorm's ``num_batches_tracked`` (no JAX importer reads one) is 0
    where the file has none, and a key the module needs and the file lacks
    raises, naming it (JAX's importers raise ``KeyError``)."""
    out: Dict[str, torch.Tensor] = {}
    for k, ref in module.state_dict().items():
        if prefix + k in sd:
            out[k] = torch.as_tensor(sd[prefix + k])
        elif k.endswith("num_batches_tracked"):
            out[k] = torch.zeros_like(ref, device="cpu")
        else:
            raise RuntimeError(f"the state dict has no key {prefix + k!r} "
                               f"({type(module).__name__} needs it)")
    return out


def load_frozen_tower(module: torch.nn.Module, path: str, prefix: str = "") -> torch.nn.Module:
    """Load a frozen tower's reference checkpoint (FAN, EmoNet) as JAX reads
    one: ``load_torch_state_dict``, then the module's own keys
    (``own_state``)."""
    module.load_state_dict(own_state(module, load_torch_state_dict(path), prefix), strict=True)
    return module


def _strip(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _take(out: Dict[str, torch.Tensor], sd: Mapping[str, Any], name: str, src: str = None) -> None:
    out[name] = torch.as_tensor(sd[src or name])


def brain_state_from_torch(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's ``voxel2clip`` (BrainNetwork) state, less its prefix
    -> the port's: the same names, the keys JAX's ``_brain_from_torch``
    reads (``lin0``, the ``mlp`` blocks there are, ``lin1``, the projector
    where the checkpoint has one)."""
    out: Dict[str, torch.Tensor] = {}
    names = ["lin0.0", "lin0.1", "lin1"]
    i = 0
    while f"mlp.{i}.0.weight" in sd:
        names += [f"mlp.{i}.0", f"mlp.{i}.1"]
        i += 1
    if "projector.0.weight" in sd:
        names += [f"projector.{j}" for j in (0, 2, 3, 5, 6, 8)]
    for n in names:
        _take(out, sd, n + ".weight")
        if n + ".bias" in sd:
            _take(out, sd, n + ".bias")
    return out


def prior_net_state_from_torch(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """dalle2 ``VersatileDiffusionPriorNetwork`` state, less its ``net.``
    prefix -> the port's ``PriorTransformerNetwork`` state: the keys JAX's
    ``_prior_net_from_torch`` reads, under the same names but the feed-forward
    spelled ``layers.{i}.1.net.{0,1,5}`` in some releases (the port's is
    ``layers.{i}.1.{0,1,5}``)."""
    out: Dict[str, torch.Tensor] = {}
    for n in ("null_brain_embeds", "null_image_embed", "learned_query",
              "causal_transformer.rel_pos_bias.relative_attention_bias.weight",
              "causal_transformer.norm.g", "causal_transformer.project_out.weight"):
        _take(out, sd, n)
    for n in ("to_time_embeds.0.1.net.0.0", "to_time_embeds.0.1.net.1.0",
              "to_time_embeds.0.1.net.2"):
        _take(out, sd, n + ".weight")
        if n + ".bias" in sd:
            _take(out, sd, n + ".bias")
    i = 0
    while f"causal_transformer.layers.{i}.0.to_q.weight" in sd:
        ap, fp = f"causal_transformer.layers.{i}.0.", f"causal_transformer.layers.{i}.1."
        for n in ("norm.g", "null_kv", "to_q.weight", "to_kv.weight", "to_out.0.weight",
                  "to_out.1.g"):
            _take(out, sd, ap + n)
        for n in ("0.g", "1.weight", "5.weight"):
            _take(out, sd, fp + n, fp + n if fp + n in sd else fp + "net." + n)
        i += 1
    return out


def import_prior_checkpoint(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """The reference prior trainer's ``last.pth`` / ``best.pth`` -> ``{"brain",
    "prior"}`` state dicts of the port. Its ``model_state_dict`` holds
    ``voxel2clip.*`` (the brain) and ``net.*`` (the prior network)."""
    sd = load_torch_state_dict(path)
    return {"brain": brain_state_from_torch(_strip(sd, "voxel2clip.")),
            "prior": prior_net_state_from_torch(_strip(sd, "net."))}
