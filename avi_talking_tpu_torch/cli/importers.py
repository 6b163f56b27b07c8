"""Importers of the reference's published files into the port's checkpoints
(port of ``avi_talking_tpu/cli/importers.py`` but ``translate-captions``).

Each writes a pipeline checkpoint (``infra.checkpoint``: ``<out>/state.pt``
holding the parts it has) that ``--checkpoint`` reads; several can be given
together. ``import-clip`` vendors the CLIP BPE vocab, and with ``--weights``
also imports an HF ``CLIPTextModel`` state dict.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing
from pathlib import Path


def _count(state) -> int:
    return sum(t.numel() for part in state.values() for t in part.values())


def _discover_tokenizer():
    """A usable CLIP vocab for imported real weights: the usual discovery
    chain, then one copy of any CLIP snapshot in the user's HF cache into
    the repository's ``assets/clip_tokenizer/``. Returns its directory or
    None."""
    from ..text import find_tokenizer_assets
    from ..text.clip_bpe import import_tokenizer_assets

    found = find_tokenizer_assets()
    if found is not None:
        return found
    hf = Path(os.environ.get("HF_HOME", Path.home() / ".cache" / "huggingface"))
    try:
        dest = import_tokenizer_assets(hf)
    except (FileNotFoundError, ValueError):
        return None
    print(f"vendored CLIP tokenizer from the HF cache -> {dest}")
    return dest


def cmd_import_prior(args) -> int:
    """The reference's diffusion-prior ``.pth`` (last / best) -> a checkpoint
    with the ``brain`` and ``prior`` parts."""
    from ..infra.checkpoint import import_prior_checkpoint, save_checkpoint

    state = import_prior_checkpoint(args.pth)
    save_checkpoint(os.path.abspath(args.out), state)
    print(f"imported {_count(state):,} prior params -> {args.out}")
    if _discover_tokenizer() is None:
        # real prior weights with a non-CLIP tokenizer read garbage ids
        raise SystemExit(
            "import-prior: real prior weights imported but no CLIP tokenizer vocab found. "
            "Run `import-clip --src <dir with vocab.json+merges.txt>` first (the checkpoint "
            "was written).")
    return 0


def cmd_import_clip(args) -> int:
    """Vendor the CLIP BPE vocab (vocab.json + merges.txt) into
    ``assets/clip_tokenizer/`` (or ``--dest``), validated; ``--src`` may be
    the pair's directory, an HF hub cache root, or any tree holding it.
    With ``--weights``, also an HF ``CLIPTextModel`` state dict -> a
    checkpoint with the ``clip`` part at ``--out``."""
    from ..text import ClipBpeTokenizer
    from ..text.clip_bpe import import_tokenizer_assets

    dest = import_tokenizer_assets(args.src, dest=args.dest)
    tok = ClipBpeTokenizer.from_dir(dest)
    print(f"validated + vendored CLIP tokenizer ({tok.vocab_size} tokens) -> {dest}")
    if args.weights:
        from ..infra.checkpoint import load_torch_state_dict, save_checkpoint
        from ..models.clip_text import clip_text_state_from_torch

        sd = load_torch_state_dict(args.weights)
        prefix = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
        state = {"clip": clip_text_state_from_torch(sd, prefix=prefix)}
        save_checkpoint(os.path.abspath(args.out), state)
        print(f"imported {_count(state):,} CLIP text params -> {args.out}")
    return 0


def _config_from_dict(cls, d):
    """A (nested) config dataclass from a JSON dict; unknown fields raise."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            raise KeyError(f"unknown config field {cls.__name__}.{k}")
        t = hints.get(k)
        if dataclasses.is_dataclass(t) and isinstance(v, dict):
            kwargs[k] = _config_from_dict(t, v)
        else:
            kwargs[k] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


def cmd_import_emote(args) -> int:
    """An EMOTE torch checkpoint -> a checkpoint with the ``head`` part
    (Lightning or bare prefixes, both squashers, FLINT's nesting)."""
    from ..infra.checkpoint import load_torch_state_dict, save_checkpoint
    from ..infra.emote_import import emote_state_from_torch
    from ..models.emote import EmoteConfig

    sd = load_torch_state_dict(args.ckpt)
    if args.config:
        with open(args.config) as f:
            cfg = _config_from_dict(EmoteConfig, json.load(f))
    else:
        cfg = EmoteConfig.tiny() if args.tiny else EmoteConfig()
    state = {"head": emote_state_from_torch(sd, cfg)}
    save_checkpoint(os.path.abspath(args.out), state)
    print(f"imported {_count(state):,} EMOTE params -> {args.out}")
    return 0


def register(sub, common):
    ip = sub.add_parser("import-prior", help="reference prior .pth -> checkpoint")
    ip.add_argument("--pth", required=True)
    ip.add_argument("--out", default="checkpoints/prior")
    ip.set_defaults(fn=cmd_import_prior)

    ic = sub.add_parser("import-clip",
                        help="vendor + validate the CLIP BPE vocab into assets/clip_tokenizer")
    ic.add_argument("--src", required=True,
                    help="dir with vocab.json+merges.txt, or an HF cache root")
    ic.add_argument("--dest", default=None,
                    help="target dir (default: repo assets/clip_tokenizer)")
    ic.add_argument("--weights", default=None,
                    help="an HF CLIPTextModel state dict (.bin / .pt) to import too")
    ic.add_argument("--out", default="checkpoints/clip", help="the --weights checkpoint")
    ic.set_defaults(fn=cmd_import_clip)

    ie = sub.add_parser("import-emote", help="EMOTE torch ckpt -> checkpoint")
    ie.add_argument("--ckpt", required=True)
    ie.add_argument("--out", default="checkpoints/emote")
    ie.add_argument("--tiny", action="store_true")
    ie.add_argument("--config", default=None, help="EmoteConfig JSON matching the ckpt layout")
    ie.set_defaults(fn=cmd_import_emote)
