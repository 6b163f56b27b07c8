"""train-faceformer: stage-1 coefficient-space FaceFormer training, on
synthetic batches or, with ``--root``, on an EMOCA-preprocessed MEAD tree:
the coefficient windows and audio of ``data.train_batches.
FaceFormerBatchBuilder`` and, where the config merges conditions (the full
``FaceFormerConfig()`` does), the eye / emotion embeddings and reference
coefficients that ``FanConditioner`` computes from the window's detection
crops with a frozen FAN (seed 1, or ``--fan-checkpoint``). At full size,
FLAME assets (``--flame-npz``, else the default assets where found) add the
landmark terms, as in the JAX command; ``--ckpt-dir`` saves the trained
weights (``infra.checkpoint``). Under ``--root``, ``--render-loss`` adds
the frozen PIRender's upper-face perceptual terms and ``--emo-loss`` EmoNet's
feature distance on the same renders (``train.render_loss``; towers at
seeded random init, EmoNet from ``--emonet-checkpoint`` where given);
without ``--root`` both are ignored, as in the JAX command."""

from __future__ import annotations

import sys
import time

NO_CROPS = ("conditioning / render loss needs detection crops under the data root (EMOCA "
            "detections/*.png)")

# Flags the JAX command parses (through the shared parser) and never reads:
# the port takes them too, and says on stderr that it ignores them.
IGNORED = {
    "bf16": "--bf16 is ignored, as in the JAX command: the run computes in float32",
    "checkpoint": "--checkpoint is ignored, as in the JAX command: the run starts from "
                  "seeded random weights",
}


def synthetic_batches(cfg, batch_size: int, seq_length: int, seed: int, device):
    """Endless synthetic batches from ``numpy.random.default_rng(seed)``,
    drawn in the JAX command's order."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    B, T = batch_size, seq_length

    def draw(shape):
        return rng.standard_normal(shape).astype(np.float32)

    while True:
        out = {"audio": draw((B, T * 640)), "coeff": draw((B, T, cfg.vertice_dim)) * 0.3}
        if cfg.with_condition_merge:
            out["eye_embed"] = draw((B, T, cfg.eye_dim))
            out["emo_embed"] = draw((B, T, cfg.emo_dim))
            out["ref_coeff"] = draw((B, 1, cfg.vertice_dim))
        yield {k: torch.from_numpy(a).to(device) for k, a in out.items()}


def frozen_fan(args, image_size: int, device):
    """The conditioning FAN at the crops' size: ``--fan-checkpoint`` (a
    reference-named state dict, read as JAX reads it: ``infra.checkpoint.
    load_frozen_tower``) or seeded random weights (seed 1: a random FAN's single-channel ``conv6`` is dead
    for seeds 0, 2 and 5, and its embeddings would not vary)."""
    from ..infra.checkpoint import load_frozen_tower
    from ..models.fan_encoder import FanEncoder

    fan = FanEncoder.random_init(image_size, seed=1, device=device)
    if args.fan_checkpoint:
        load_frozen_tower(fan, args.fan_checkpoint)
    else:
        print("train-faceformer: no --fan-checkpoint; the frozen FanEncoder is RANDOM-init "
              "(smoke semantics)", file=sys.stderr)
    return fan


def _render_flags(args) -> bool:
    return bool(getattr(args, "render_loss", False) or getattr(args, "emo_loss", False))


def mead_builder(args, cfg):
    """``--root``'s ``FaceFormerBatchBuilder``, reading the crops where the
    config merges conditions or a render term needs them."""
    from ..data.mead import MeadEmocaDataset
    from ..data.train_batches import FaceFormerBatchBuilder

    ds = MeadEmocaDataset(root=args.root, seq_length=args.seq_length)
    builder = FaceFormerBatchBuilder(ds, frames=args.seq_length, coeff_dim=cfg.vertice_dim,
                                     load_images=cfg.with_condition_merge or _render_flags(args))
    if len(builder) == 0:
        raise SystemExit(f"no usable MEAD clips under {args.root}")
    return builder


def mead_source(args, cfg, device, builder=None):
    """``--root``'s (endless numpy batches, conditioner): shuffled epochs of
    ``FaceFormerBatchBuilder`` items in batches of min(batch size, clips),
    and a ``FanConditioner`` seeded ``--seed`` where the config merges
    conditions (else None)."""
    from ..data.batching import batch_iterator
    from ..data.train_batches import FanConditioner
    from ..viz.pngio import read_png

    builder = builder or mead_builder(args, cfg)
    ds = builder.ds
    batches = batch_iterator(builder, batch_size=min(args.batch_size, len(builder)), epochs=None)
    if not cfg.with_condition_merge:
        return batches, None
    crops = ds.image_paths(builder.valid[0])
    if not crops:
        raise SystemExit(NO_CROPS)
    return batches, FanConditioner(frozen_fan(args, read_png(crops[0]).shape[0], device),
                                   seed=args.seed)


def conditioned(b, cfg, conditioner, device, render: bool = False):
    """A numpy batch -> the trainer's batch on ``device``: audio and
    coefficients, with the conditioner's eye / emotion embeddings and
    reference coefficients where there is one, and with ``render`` the
    render term's pose, camera and crops (NHWC; the frame's own crops as
    the reference where the batch has no neutral ones)."""
    import numpy as np
    import torch

    out = {"audio": torch.from_numpy(b["audio"]).to(device),
           "coeff": torch.from_numpy(b["coeff"][..., :cfg.vertice_dim]).to(device)}
    if (conditioner is not None or render) and ("img" not in b or not hasattr(b["img"], "ndim")):
        raise SystemExit(NO_CROPS)
    if conditioner is not None:
        out.update(conditioner.condition(b["img"], np.asarray(b["coeff"])))
        out["ref_coeff"] = out["ref_coeff"][..., :cfg.vertice_dim]
    if render:
        for key, src in (("pose", "pose"), ("cam", "cam"), ("img", "img"),
                         ("ref_img", "ref_img" if "ref_img" in b else "img")):
            out[key] = torch.from_numpy(np.ascontiguousarray(b[src])).to(device)
    return out


def render_term(args, cfg, builder, device):
    """``--render-loss`` / ``--emo-loss``'s ``PIRenderRenderLoss``, built as
    the JAX command builds it: two frames a step, the dataset's statistics,
    a seeded random PIRender (seed 2) and VGG19 (seed 3; the tiny config
    taps ``relu_1_1`` at one scale), and with ``--emo-loss`` EmoNet (seed 4,
    or ``--emonet-checkpoint``, a reference-named state dict read as JAX
    reads it). The frames are drawn from a generator seeded ``--seed``
    (JAX: ``PRNGKey(0)`` on every step). Reads one item first, as JAX's
    probe does, so the dataset's draws stay JAX's."""
    import dataclasses

    import torch

    from ..data.stats import CoeffStats
    from ..infra.checkpoint import load_frozen_tower
    from ..infra.init import random_module
    from ..models.emoca import EmoNetLoss, EmotionRecognitionModule
    from ..models.pirender import FaceGenerator, PIRenderConfig
    from ..train.perceptual import ALL_TAPS, PerceptualLoss, Vgg19Features
    from ..train.render_loss import PIRenderRenderLoss

    if "img" not in builder[0]:
        raise SystemExit("--render-loss needs detection crops under the data root (EMOCA "
                         "detections/*.png); none found")
    if args.tiny:
        pir_cfg, taps, scales = PIRenderConfig.tiny(), ("relu_1_1",), 1
    else:
        pir_cfg, taps, scales = PIRenderConfig(), ALL_TAPS, 3
    # descriptor = exp (d - 3) | rot3 | jaw3 | cam3: 59-d at full size
    pir_cfg = dataclasses.replace(pir_cfg, coeff_nc=cfg.vertice_dim + 6)
    gen = FaceGenerator.random_init(pir_cfg, seed=2, device=device)
    vgg = Vgg19Features.random_init(taps, seed=3, device=device)
    emonet = None
    if args.emo_loss:
        emo = random_module(lambda: EmotionRecognitionModule(n_expression=8), device,
                            torch.Generator().manual_seed(4))
        if args.emonet_checkpoint:
            load_frozen_tower(emo, args.emonet_checkpoint)
        else:
            print("train-faceformer: no --emonet-checkpoint; the frozen EmoNet is RANDOM-init "
                  "(smoke semantics)", file=sys.stderr)
        emonet = EmoNetLoss(emo)
    stats = builder.ds.stats or CoeffStats.identity(59)
    print("train-faceformer: --render-loss with RANDOM-init PIRender/VGG towers (smoke "
          "semantics)", file=sys.stderr)
    return PIRenderRenderLoss(
        generator=gen, perceptual_warp=PerceptualLoss(vgg, layers=taps, num_scales=scales),
        perceptual_final=PerceptualLoss(vgg, layers=taps, num_scales=scales),
        coeff_mean=torch.as_tensor(stats.mean, device=device),
        coeff_std=torch.as_tensor(stats.std, device=device), n_samples=2, emonet=emonet,
        seed=args.seed)


def mead_batches(args, cfg, device):
    """``--root``'s (endless batches, render term or None), drawn as the JAX
    command draws them."""
    builder = mead_builder(args, cfg)
    batches, conditioner = mead_source(args, cfg, device, builder)
    render = render_term(args, cfg, builder, device) if _render_flags(args) else None

    def gen():
        while True:
            yield conditioned(next(batches), cfg, conditioner, device, render is not None)
    return gen(), render


def landmark_flame(args, device):
    """The FLAME of the landmark terms: none with ``--tiny`` (its synthetic
    FLAME has no 68-point layout, and the JAX command leaves the terms out),
    else from ``--flame-npz`` or the default assets, where found."""
    from ..core.assets import default_assets_path, load_flame_assets
    from ..core.flame import FlameModel

    npz = None if args.tiny else (args.flame_npz or default_assets_path())
    if not npz:
        return None
    return FlameModel(load_flame_assets(npz, 100, 50).to(device), n_shape=100, n_exp=50)


def cmd_train_faceformer(args) -> int:
    import torch

    from ..infra.checkpoint import save_checkpoint
    from ..infra.device import resolve_device
    from ..models.faceformer import FaceFormerCoeff, FaceFormerConfig
    from ..train.faceformer_trainer import FaceFormerTrainer
    from ..train.optim import adamw

    for name, note in IGNORED.items():
        if getattr(args, name, None):
            print(f"train-faceformer: {note}", file=sys.stderr)
    device = resolve_device(args.device)
    cfg = FaceFormerConfig.tiny() if args.tiny else FaceFormerConfig()
    model = FaceFormerCoeff.random_init(cfg, seed=args.seed, device=device)
    flame = landmark_flame(args, device)
    render = None
    if args.root:
        batches, render = mead_batches(args, cfg, device)
    else:
        batches = synthetic_batches(cfg, args.batch_size, args.seq_length, args.seed, device)
        if _render_flags(args):
            print("train-faceformer: --render-loss / --emo-loss need --root (the detection "
                  "crops); ignored without it, as in the JAX command", file=sys.stderr)
    if args.emonet_checkpoint and not (args.root and args.emo_loss):
        print("train-faceformer: --emonet-checkpoint is read only with --root --emo-loss; "
              "ignored", file=sys.stderr)
    zeros = torch.zeros(cfg.vertice_dim, device=device)
    trainer = FaceFormerTrainer(model=model, optimizer=adamw(model.parameters(), args.lr),
                                flame=flame, coeff_mean=zeros, coeff_std=zeros + 1.0,
                                render_loss_fn=render,
                                render_weight=0.015 if args.render_loss else 0.0)
    next(batches)  # the JAX command draws its first batch to initialise the params

    metrics = {}
    t0 = time.time()
    for i in range(args.steps):
        metrics = trainer.train_step(next(batches))
        if (i + 1) % 50 == 0:
            print(f"step {i+1}: " + " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
                  + f" ({(i+1)/(time.time()-t0):.1f} it/s)")
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, {"params": model.state_dict()})
    print("final:", {k: float(v) for k, v in metrics.items()})
    return 0


def register(sub, common):
    tf = sub.add_parser("train-faceformer", help="stage-1 FaceFormer training")
    tf.add_argument("--steps", type=int, default=200)
    tf.add_argument("--batch-size", type=int, default=16)
    tf.add_argument("--seq-length", type=int, default=25)
    tf.add_argument("--lr", type=float, default=1e-4)
    tf.add_argument("--root", default=None, help="MEAD / EMOCA data root")
    tf.add_argument("--fan-checkpoint", default=None,
                    help="reference-named torch FanEncoder state dict for the frozen "
                         "conditioning tower (seeded random without it)")
    tf.add_argument("--render-loss", action="store_true",
                    help="the PIRender upper-face render loss (needs --root with detection "
                         "crops)")
    tf.add_argument("--emo-loss", action="store_true",
                    help="the EmoNet feature loss on the PIRender renders (needs --root with "
                         "detection crops)")
    tf.add_argument("--emonet-checkpoint", default=None,
                    help="reference-named torch EmotionRecognition state dict for the frozen "
                         "EmoNet tower (seeded random without it)")
    tf.add_argument("--ckpt-dir", default=None)
    common(tf)
    tf.set_defaults(fn=cmd_train_faceformer)
