"""train-prior: the diffusion-prior training loop on the structured
synthetic stream (the JAX command without a corpus)."""

from __future__ import annotations

REFUSED = {
    "json_dir": "--json-dir (the caption corpus) needs the frozen CLIP and style featurizer "
                "bridge, data/prior_corpus.py (ROADMAP Queue 1, item 1)",
    "root": "--root (MEAD captions) needs data/prior_corpus.py and data/mead.py "
            "(ROADMAP Queue 1, item 1)",
    "captions": "--captions feeds --root (ROADMAP Queue 1, item 1)",
    "pipeline_checkpoint": "--pipeline-checkpoint needs checkpoint import (ROADMAP Queue 1, "
                           "item 4)",
    "emote_checkpoint": "--emote-checkpoint needs checkpoint import (ROADMAP Queue 1, item 4)",
    "dp": "--dp needs the data-parallel port (ROADMAP Queue 1, item 7)",
}


def cmd_train_prior(args) -> int:
    from ..train.driver import PriorTrainingConfig, train_prior

    for name, why in REFUSED.items():
        if getattr(args, name, None):
            raise SystemExit(f"train-prior: not ported to avi_talking_tpu_torch yet: {why}")
    cfg = PriorTrainingConfig(
        total_steps=args.steps, batch_size=args.batch_size, max_lr=args.lr,
        val_every=args.val_every, val_steps=args.val_steps, resume=args.resume,
        **(dict(clip_size=32, in_dim=32, depth=2, heads=4, dim_head=8, brain_hidden=64)
           if args.tiny else {}))
    res = train_prior(cfg, logdir=args.logdir, ckpt_dir=args.ckpt_dir, device=args.device)
    print("final:", res["metrics"])
    if res["val_history"]:
        print(f"best val loss: {res['best_val_loss']:.4f} "
              f"(best={res['best_ckpt']}, last={res['last_ckpt']})")
    return 0


def register(sub, common):
    t = sub.add_parser("train-prior", help="diffusion prior training loop (synthetic batches)")
    t.add_argument("--steps", type=int, default=500)
    t.add_argument("--batch-size", type=int, default=256)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--logdir", default=None)
    t.add_argument("--ckpt-dir", default=None)
    t.add_argument("--val-every", type=int, default=0,
                   help="validate every N steps; tags best/last checkpoints")
    t.add_argument("--val-steps", type=int, default=4)
    t.add_argument("--resume", action="store_true", help="restore <ckpt-dir>/last first")
    t.add_argument("--tiny", action="store_true", help="test-sized prior dims")
    for flag in ("--json-dir", "--root", "--captions", "--pipeline-checkpoint",
                 "--emote-checkpoint"):
        t.add_argument(flag, default=None, help="(not ported yet)")
    t.add_argument("--dp", action="store_true", help="(not ported yet)")
    t.add_argument("--device", default=None,
                   help="torch device; the default is the CUDA card, and no card is an error")
    t.set_defaults(fn=cmd_train_prior)
