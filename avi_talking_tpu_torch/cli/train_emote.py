"""train-emote: the staged EMOTE training loop: a geometric stage at
``--lr``, then a condition-exchange stage at ``--lr / 2``, which with
``--neural`` adds the perceptual terms (lip reading, EmoNet, video emotion
over renders of the head's FLAME vertices, with towers at seeded random
init). Batches are synthetic, or with ``--root`` the windows of an
EMOCA-preprocessed MEAD tree (``data.train_batches.EmoteBatchBuilder``),
split by clip into train and val (``--val-fraction``)."""

from __future__ import annotations

import itertools
import sys

REFUSED = {
    "bf16": "--bf16 trains the towers at bfloat16 through K1's bfloat16 backward (ROADMAP "
            "Queue 2, train-emote --bf16; generate / instruct / serve take --bf16)",
}


def synthetic_batches(rng, batch_size: int, frames: int, n_exp: int, n_shape: int, device):
    """Endless batches drawn from the numpy Generator ``rng`` in the JAX
    command's order: audio frames, one-hot expression (9) / intensity (3) /
    identity (32), zero shape, gt exp and jaw."""
    import numpy as np
    import torch

    B, T = batch_size, frames
    while True:
        out = {
            "raw_audio": rng.standard_normal((B, T, 640)).astype(np.float32),
            "expression": np.eye(9, dtype=np.float32)[rng.integers(0, 9, B)],
            "intensity": np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)],
            "identity": np.eye(32, dtype=np.float32)[rng.integers(0, 32, B)],
            "shape": np.zeros((B, n_shape), np.float32),
            "gt_exp": rng.standard_normal((B, T, n_exp)).astype(np.float32) * 0.1,
            "gt_jaw": rng.standard_normal((B, T, 3)).astype(np.float32) * 0.05,
        }
        yield {k: torch.from_numpy(a).to(device) for k, a in out.items()}


def mead_batches(root: str, batch_size: int, frames: int, n_exp: int, n_shape: int,
                 val_fraction: float, device):
    """``--root``'s streams, as the JAX command builds them: (endless
    shuffled training batches, one unshuffled validation epoch), each
    batch of min(batch_size, clips on its side) moved to ``device``."""
    import torch

    from ..data.mead import MeadEmocaDataset
    from ..data.train_batches import EmoteBatchBuilder, emote_batches

    builder = EmoteBatchBuilder(MeadEmocaDataset(root=root, seq_length=frames), frames=frames,
                                n_exp=n_exp, n_shape=n_shape)
    if len(builder) == 0:
        raise SystemExit(f"no usable MEAD clips under {root}")
    tr_b, va_b = builder.split(val_fraction)
    print(f"data root: {len(tr_b)} train / {len(va_b)} val clips")
    # the JAX command reads one batch to initialise the head; its window
    # draws move the dataset's generator, so the port reads it too
    next(emote_batches(tr_b, min(batch_size, len(tr_b)), epochs=1))

    def put(stream):
        return ({k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in stream)

    return (lambda: put(emote_batches(tr_b, min(batch_size, len(tr_b)), epochs=None)),
            lambda: put(emote_batches(va_b, min(batch_size, len(va_b)), shuffle=False,
                                      epochs=1)))


def build_head(tiny: bool, seed: int, device, flame_assets=None):
    """The head ``train-emote`` trains: ``EmoteConfig()`` (or ``.tiny()``)
    with seeded random weights and a style encoder over the batches' 9 + 3
    + 32 + n_shape condition; with ``flame_assets`` it also decodes FLAME
    vertices."""
    import torch

    from ..infra.init import random_module
    from ..models.emote import EmoteConfig, EmoteTalkingHead

    cfg = EmoteConfig.tiny() if tiny else EmoteConfig()
    assets = None if flame_assets is None else flame_assets.to(device)
    return random_module(
        lambda: EmoteTalkingHead(cfg, flame_assets=assets,
                                 condition_dim=9 + 3 + 32 + cfg.n_shape),
        device, torch.Generator().manual_seed(seed))


def neural_assets(tiny: bool):
    """The FLAME model the neural stage renders: the tiny config's synthetic
    one, else a converted FLAME file where one is found, else synthetic at
    FLAME's size (5023 vertices, 9976 faces)."""
    from ..core.assets import default_assets_path, load_flame_assets, synthetic_assets
    from ..models.emote import EmoteConfig

    cfg = EmoteConfig.tiny() if tiny else EmoteConfig()
    if tiny:
        return synthetic_assets(n_shape=cfg.n_shape, n_exp=cfg.flint.n_exp)
    npz = default_assets_path()
    if npz:
        return load_flame_assets(npz, cfg.n_shape, cfg.n_exp)
    return synthetic_assets(num_vertices=5023, n_shape=cfg.n_shape, n_exp=cfg.n_exp,
                            num_faces=9976)


def build_neural(tiny: bool, faces, device, seed: int = 7):
    """The JAX command's perceptual suite: renders at 224^2 (24^2 tiny), the
    lip-reading net (its crop is ``mouth_transform``'s 88^2, or a smaller
    frame's whole mouth box), EmoNet with 8 expressions, a one-layer
    video-emotion classifier (feature_dim 128 / 8 heads, tiny 32 / 4);
    weights 1, 1, 0.1. The towers are drawn, in that order, from one CPU
    generator seeded ``seed``."""
    import torch

    from ..infra.init import random_module
    from ..models.emoca import EmoNetLoss, EmotionRecognitionModule
    from ..models.lipread import LipReadingLoss, LipReadingNet
    from ..models.video_emotion import VideoEmotionClassifier, VideoEmotionLoss
    from ..train.talking_head import NeuralLosses
    from ..viz.visualizer import FixedViewRenderer

    g = torch.Generator().manual_seed(seed)
    lip = random_module(LipReadingNet, device, g)
    emo = random_module(lambda: EmotionRecognitionModule(n_expression=8), device, g)
    vemo = random_module(lambda: VideoEmotionClassifier(
        n_classes=8, feature_dim=32 if tiny else 128, num_layers=1, nhead=4 if tiny else 8,
        input_dim=2048), device, g)
    return NeuralLosses(
        renderer=FixedViewRenderer(faces, image_size=24 if tiny else 224, device=device),
        lipread=LipReadingLoss(lip), lipread_weight=1.0,
        emonet=EmoNetLoss(emo), emotion_weight=1.0,
        video_emotion=VideoEmotionLoss(vemo), video_emotion_weight=0.1)


def cmd_train_emote(args) -> int:
    import numpy as np

    from ..infra.device import resolve_device
    from ..train.emote_driver import EmoteStage, train_emote

    for name, why in REFUSED.items():
        if getattr(args, name, None):
            raise SystemExit(f"train-emote: not ported to avi_talking_tpu_torch yet: {why}")
    device = resolve_device(args.device)
    neural = assets = None
    if args.neural:
        assets = neural_assets(args.tiny)
        neural = build_neural(args.tiny, assets.faces, device)
        print("train-emote --neural: perception towers are RANDOM-init "
              "(import real lipread/EmoNet checkpoints for product runs)", file=sys.stderr)
    head = build_head(args.tiny, seed=0, device=device, flame_assets=assets)  # JAX: PRNGKey(0)
    cfg = head.cfg
    T = args.frames - args.frames % cfg.flint.latent_frame_size
    draw = (args.batch_size, T, cfg.flint.n_exp, cfg.n_shape, device)
    if args.root:
        batches, val_batches = mead_batches(args.root, *draw[:4], args.val_fraction, device)
    else:
        rng = np.random.default_rng(0)
        batches = lambda: synthetic_batches(rng, *draw)  # noqa: E731  (one stream, continued)
        # a disjoint validation stream: early stopping and "best" must not read training data
        val_cached = list(itertools.islice(
            synthetic_batches(np.random.default_rng(99_991), *draw), 2))
        val_batches = lambda: iter(val_cached)  # noqa: E731
    stages = [
        EmoteStage(name="geometric", steps=args.steps, lr=args.lr),
        EmoteStage(name="disentangled", steps=args.steps, lr=args.lr / 2,
                   disentangle="condition_exchange", use_neural=neural is not None),
    ]
    res = train_emote(head, batches, stages=stages, neural=neural,
                      val_batches=val_batches,
                      val_every=args.val_every, early_stop_patience=args.early_stop_patience,
                      run_dir=args.run_dir)
    print(f"done: {res['total_steps']} steps, best val {res['best_val']:.4f}")
    return 0


def register(sub, common):
    te = sub.add_parser("train-emote", help="staged EMOTE training loop")
    te.add_argument("--steps", type=int, default=200, help="steps per stage")
    te.add_argument("--batch-size", type=int, default=8)
    te.add_argument("--frames", type=int, default=64)
    te.add_argument("--lr", type=float, default=1e-4)
    te.add_argument("--val-every", type=int, default=50)
    te.add_argument("--early-stop-patience", type=int, default=0)
    te.add_argument("--run-dir", default=None)
    te.add_argument("--tiny", action="store_true")
    te.add_argument("--root", default=None,
                    help="EMOCA-preprocessed MEAD root; without it the loop runs on synthetic "
                         "batches")
    te.add_argument("--val-fraction", type=float, default=0.1,
                    help="held-out clip fraction of --root")
    te.add_argument("--neural", action="store_true",
                    help="add the perceptual terms (renders + lip-reading / EmoNet / "
                         "video-emotion towers) to the second stage; gt meshes are decoded "
                         "in the loss from the coefficients")
    te.add_argument("--bf16", action="store_true", help="(not ported yet)")
    te.add_argument("--device", default=None,
                    help="torch device; the default is the CUDA card, and no card is an error")
    te.set_defaults(fn=cmd_train_emote)
