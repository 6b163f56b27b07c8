"""train-emote: the staged EMOTE training loop: a geometric stage at
``--lr``, then a condition-exchange stage at ``--lr / 2``, which with
``--neural`` adds the perceptual terms (lip reading, EmoNet, video emotion
over renders of the head's FLAME vertices, with towers at seeded random
init). Batches are synthetic, or with ``--root`` the windows of an
EMOCA-preprocessed MEAD tree (``data.train_batches.EmoteBatchBuilder``),
split by clip into train and val (``--val-fraction``). ``--bf16`` builds
the head and the towers at a bfloat16 compute dtype over float32 weights,
as the JAX command does: K1's bfloat16 kernel runs in every wav2vec2 layer
of the step, and its backward is the float32 recompute.

train-flint: FLINT, EMOTE's stage-0 motion prior, trained as a VAE (or a
VQ-VAE with ``--vq``) on synthetic motion, or with ``--root`` on the
exp + jaw windows of a MEAD tree."""

from __future__ import annotations

import itertools
import sys

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


def build_head(tiny: bool, seed: int, device, flame_assets=None, dtype=None):
    """The head ``train-emote`` trains: ``EmoteConfig()`` (or ``.tiny()``)
    with seeded random weights and a style encoder over the batches' 9 + 3
    + 32 + n_shape condition, at the compute ``dtype`` (float32 when None);
    with ``flame_assets`` it also decodes FLAME vertices."""
    import torch

    from ..infra.init import random_module
    from ..models.emote import EmoteConfig, EmoteTalkingHead

    cfg = EmoteConfig.tiny() if tiny else EmoteConfig()
    assets = None if flame_assets is None else flame_assets.to(device)
    return random_module(
        lambda: EmoteTalkingHead(cfg, flame_assets=assets,
                                 condition_dim=9 + 3 + 32 + cfg.n_shape,
                                 dtype=dtype or torch.float32),
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


def build_neural(tiny: bool, faces, device, seed: int = 7, dtype=None):
    """The JAX command's perceptual suite: renders at 224^2 (24^2 tiny), the
    lip-reading net (its crop is ``mouth_transform``'s 88^2, or a smaller
    frame's whole mouth box), EmoNet with 8 expressions, a one-layer
    video-emotion classifier (feature_dim 128 / 8 heads, tiny 32 / 4);
    weights 1, 1, 0.1. The towers run at the compute ``dtype`` (float32
    when None) and are drawn, in that order, from one CPU generator seeded
    ``seed``."""
    import torch

    from ..infra.init import random_module
    from ..models.emoca import EmoNetLoss, EmotionRecognitionModule
    from ..models.lipread import LipReadingLoss, LipReadingNet
    from ..models.video_emotion import VideoEmotionClassifier, VideoEmotionLoss
    from ..train.talking_head import NeuralLosses
    from ..viz.visualizer import FixedViewRenderer

    dt = dtype or torch.float32
    g = torch.Generator().manual_seed(seed)
    lip = random_module(lambda: LipReadingNet(dtype=dt), device, g)
    emo = random_module(lambda: EmotionRecognitionModule(n_expression=8, dtype=dt), device, g)
    vemo = random_module(lambda: VideoEmotionClassifier(
        n_classes=8, feature_dim=32 if tiny else 128, num_layers=1, nhead=4 if tiny else 8,
        input_dim=2048, dtype=dt), device, g)
    return NeuralLosses(
        renderer=FixedViewRenderer(faces, image_size=24 if tiny else 224, device=device),
        lipread=LipReadingLoss(lip), lipread_weight=1.0,
        emonet=EmoNetLoss(emo), emotion_weight=1.0,
        video_emotion=VideoEmotionLoss(vemo), video_emotion_weight=0.1)


def cmd_train_emote(args) -> int:
    import numpy as np
    import torch

    from ..infra.device import resolve_device
    from ..train.emote_driver import EmoteStage, train_emote

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32  # the head's and the towers'
    neural = assets = None
    if args.neural:
        assets = neural_assets(args.tiny)
        neural = build_neural(args.tiny, assets.faces, device, dtype=dtype)
        print("train-emote --neural: perception towers are RANDOM-init "
              "(import real lipread/EmoNet checkpoints for product runs)", file=sys.stderr)
    head = build_head(args.tiny, seed=0, device=device, flame_assets=assets,  # JAX: PRNGKey(0)
                      dtype=dtype)
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


def flint_config(tiny: bool):
    """``FlintConfig()``, or the JAX command's tiny one."""
    from ..models.flint import FlintConfig

    return (FlintConfig(feature_dim=32, bottleneck_dim=32, quant_factor=2, nhead=4,
                        intermediate_size=64, out_dim=9, n_exp=6)
            if tiny else FlintConfig())


def flint_batches(args, fcfg, T: int):
    """The command's endless (B, T, out_dim) float32 motion batches: the
    exp + jaw windows of ``--root`` (``EmoteBatchBuilder``), else N(0, 0.1^2)
    drawn from ``default_rng(--seed)``, as the JAX command draws them."""
    import numpy as np

    B = args.batch_size
    if args.root:
        from ..data.mead import MeadEmocaDataset
        from ..data.train_batches import EmoteBatchBuilder, emote_batches

        builder = EmoteBatchBuilder(MeadEmocaDataset(root=args.root, seq_length=T), frames=T,
                                    n_exp=fcfg.n_exp, n_shape=8 if args.tiny else 300)
        if len(builder) == 0:
            raise SystemExit(f"no usable MEAD clips under {args.root}")
        print(f"data root: {len(builder)} clips")
        for b in emote_batches(builder, min(B, len(builder)), epochs=None):
            yield np.concatenate([b["gt_exp"], b["gt_jaw"]], axis=-1)
    else:
        rng = np.random.default_rng(args.seed)
        while True:
            yield rng.standard_normal((B, T, fcfg.out_dim)).astype(np.float32) * 0.1


def cmd_train_flint(args) -> int:
    from ..infra.device import resolve_device
    from ..train.driver import train_flint_vae

    device = resolve_device(args.device)
    fcfg = flint_config(args.tiny)
    T = args.frames - args.frames % fcfg.latent_frame_size
    res = train_flint_vae(flint_batches(args, fcfg, T), total_steps=args.steps, flint_cfg=fcfg,
                          lr=args.lr, logdir=args.logdir, ckpt_dir=args.ckpt_dir,
                          seed=args.seed, quantizer="vq" if args.vq else None, device=device)
    print("final:", res["metrics"])
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
    te.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute for the head and the perception towers (float32 "
                         "weights, gradients and optimizer state)")
    te.add_argument("--device", default=None,
                    help="torch device; the default is the CUDA card, and no card is an error")
    te.set_defaults(fn=cmd_train_emote)
    tl = sub.add_parser("train-flint", help="FLINT motion-prior (VAE / VQ-VAE) training")
    tl.add_argument("--steps", type=int, default=200)
    tl.add_argument("--batch-size", type=int, default=32)
    tl.add_argument("--frames", type=int, default=64)
    tl.add_argument("--lr", type=float, default=1e-4)
    tl.add_argument("--root", default=None, help="EMOCA-preprocessed MEAD root")
    tl.add_argument("--vq", action="store_true", help="VQ-VAE mode")
    tl.add_argument("--logdir", default=None)
    tl.add_argument("--ckpt-dir", default=None)
    common(tl)
    tl.set_defaults(fn=cmd_train_flint)
