"""train-prior: the diffusion-prior training loop, on the structured
synthetic stream or, with ``--json-dir`` (+ ``--wav-dir``) or ``--root``
(+ ``--captions``), on a caption corpus featurized by the frozen CLIP text
tower and style encoder (``data.prior_corpus``), split into train and val
by clip (``--val-fraction``, read when ``--val-every`` is set)."""

from __future__ import annotations

import sys

REFUSED = {
    "pipeline_checkpoint": "--pipeline-checkpoint needs checkpoint import (ROADMAP Queue 1, "
                           "item 4b)",
    "emote_checkpoint": "--emote-checkpoint needs checkpoint import (ROADMAP Queue 1, item 4b)",
    "dp": "--dp needs the data-parallel port (ROADMAP Queue 1, item 7)",
}


def build_featurizer(tiny: bool, clip_size: int, device):
    """The frozen towers at seeded random init, from one generator seeded
    0: the CLIP text tower (``ClipTextConfig()``, or ``.tiny()``), then the
    style encoder over 9 + 3 + 32 + n_shape conditions (n_shape 300, tiny 8)."""
    import torch

    from ..data.prior_corpus import PriorCorpusFeaturizer
    from ..infra.init import random_module
    from ..models.clip_text import ClipTextConfig, ClipTextModel
    from ..models.conditioning import EmotionStyleEncoder
    from ..pipeline.generate import load_tokenizer

    clip_cfg = ClipTextConfig.tiny() if tiny else ClipTextConfig()
    n_shape = 8 if tiny else 300
    g = torch.Generator().manual_seed(0)
    clip = random_module(lambda: ClipTextModel(clip_cfg), device, g)
    enc = random_module(lambda: EmotionStyleEncoder(9 + 3 + 32 + n_shape, clip_size), device, g)
    return PriorCorpusFeaturizer(
        clip_model=clip, style_encoder=enc, shape_dim=n_shape,
        tokenizer=load_tokenizer(clip_cfg.vocab_size, clip_cfg.max_position_embeddings))


def build_prior_corpus(args, cfg, device):
    """The corpus -> (batches, val_batches) for ``train_prior``, as JAX's
    ``_build_prior_corpus``, featurized by ``build_featurizer``."""
    from ..data.prior_corpus import (
        load_corpus_items, make_val_batches, prior_corpus_batches, split_items)

    items = load_corpus_items(json_dir=args.json_dir, wav_dir=args.wav_dir,
                              mead_root=args.root, captions_path=args.captions)
    if not items:
        raise SystemExit("no (caption, condition) pairs found in the corpus")
    print(f"corpus: {len(items)} caption pairs")
    feat = build_featurizer(args.tiny, cfg.clip_size, device)
    for tower, flag in (("CLIP", "--pipeline-checkpoint"), ("style", "--emote-checkpoint")):
        print(f"train-prior: no {flag}; the frozen {tower} tower is RANDOM-init (smoke semantics)",
              file=sys.stderr)
    val_fraction = args.val_fraction if cfg.val_every else 0.0
    train_items, val_items = split_items(items, val_fraction)
    if cfg.val_every and not val_items:
        raise SystemExit(f"val split is empty ({len(items)} items, val_fraction={val_fraction}); "
                         "lower --val-every to 0 or add data")
    batches = prior_corpus_batches(train_items, feat, cfg.batch_size, cfg.total_steps)
    val_batches = (make_val_batches(val_items, feat, cfg.batch_size, cfg.val_steps)
                   if cfg.val_every else None)
    print(f"split: {len(train_items)} train / {len(val_items)} val")
    return batches, val_batches


def cmd_train_prior(args) -> int:
    from ..infra.device import resolve_device
    from ..train.driver import PriorTrainingConfig, train_prior

    for name, why in REFUSED.items():
        if getattr(args, name, None):
            raise SystemExit(f"train-prior: not ported to avi_talking_tpu_torch yet: {why}")
    device = resolve_device(args.device)
    cfg = PriorTrainingConfig(
        total_steps=args.steps, batch_size=args.batch_size, max_lr=args.lr,
        val_every=args.val_every, val_steps=args.val_steps, resume=args.resume,
        **(dict(clip_size=32, in_dim=32, depth=2, heads=4, dim_head=8, brain_hidden=64)
           if args.tiny else {}))
    batches = val_batches = None
    if args.json_dir or args.root:
        batches, val_batches = build_prior_corpus(args, cfg, device)
    res = train_prior(cfg, batches=batches, val_batches=val_batches, logdir=args.logdir,
                      ckpt_dir=args.ckpt_dir, device=device)
    print("final:", res["metrics"])
    if res["val_history"]:
        print(f"best val loss: {res['best_val_loss']:.4f} "
              f"(best={res['best_ckpt']}, last={res['last_ckpt']})")
    return 0


def register(sub, common):
    t = sub.add_parser("train-prior", help="diffusion prior training loop")
    t.add_argument("--steps", type=int, default=500)
    t.add_argument("--batch-size", type=int, default=256)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--logdir", default=None)
    t.add_argument("--ckpt-dir", default=None)
    t.add_argument("--val-every", type=int, default=0,
                   help="validate every N steps; tags best/last checkpoints")
    t.add_argument("--val-steps", type=int, default=4)
    t.add_argument("--resume", action="store_true", help="restore <ckpt-dir>/last first")
    t.add_argument("--json-dir", default=None,
                   help="caption corpus in the experiments/json_dir layout")
    t.add_argument("--wav-dir", default=None, help="the wavs of --json-dir")
    t.add_argument("--root", default=None,
                   help="EMOCA-preprocessed MEAD root (captions by clip name)")
    t.add_argument("--captions", default=None,
                   help="clip name -> caption(s) JSON for --root; generated without it")
    t.add_argument("--val-fraction", type=float, default=0.1,
                   help="held-out clip fraction of the corpus")
    t.add_argument("--tiny", action="store_true", help="test-sized CLIP and prior dims")
    for flag in ("--pipeline-checkpoint", "--emote-checkpoint"):
        t.add_argument(flag, default=None, help="(not ported yet)")
    t.add_argument("--dp", action="store_true", help="(not ported yet)")
    t.add_argument("--device", default=None,
                   help="torch device; the default is the CUDA card, and no card is an error")
    t.set_defaults(fn=cmd_train_prior)
