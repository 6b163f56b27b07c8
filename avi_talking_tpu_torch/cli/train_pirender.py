"""train-pirender: PIRender reenactment training on video pairs (the
reference's ``third_party/pirender/train.py`` / ``face_trainer.py`` recipe
on VoxDataset's sampling), from synthetic pairs or, with ``--root``, from
an EMOCA-preprocessed MEAD tree (``data.pirender_pairs``): ``--warp-steps``
warp-only steps, then the editing stage (with ``--gan`` a hinge GAN with
feature matching and a discriminator step). ``--net-g`` warm-starts from a
reference ``net_G``; ``--ckpt-dir`` writes ``{"net_G": ..., "net_D": ...}``
state dicts with ``infra.checkpoint``."""

from __future__ import annotations

import sys
import time


def _nchw(b, device):
    """A numpy batch (images NHWC, windows (B, 27, C)) -> the trainer's."""
    import torch

    return {"input_image": torch.from_numpy(b["input_image"]).to(device).permute(0, 3, 1, 2),
            "target_image": torch.from_numpy(b["target_image"]).to(device).permute(0, 3, 1, 2),
            "coeff_window": torch.from_numpy(b["coeff_window"]).to(device).transpose(1, 2)}


def pair_batches(args, coeff_nc: int):
    """(endless numpy batches, coeff_nc): ``--root``'s video pairs (59-d
    windows) or synthetic ones drawn as the JAX command draws them."""
    import numpy as np

    B, S = args.batch_size, args.image_size
    if args.root:
        from ..data.pirender_pairs import VideoPairDataset

        ds = VideoPairDataset(root=args.root, image_size=S, cross_id=args.cross_id,
                              seed=args.seed)
        if len(ds) == 0:
            raise SystemExit(f"no clips with detection crops under {args.root}")
        print(f"video-pair data: {len(ds)} clips / {len(ds.person_ids)} identities")
        return ds.batches(B), 59
    rng = np.random.default_rng(args.seed)
    print("train-pirender: no --root; synthetic pair batches (smoke)", file=sys.stderr)

    def synthetic():
        while True:
            yield {"input_image": rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32),
                   "target_image": rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32),
                   "coeff_window": rng.standard_normal((B, 27, coeff_nc)).astype(np.float32)}
    return synthetic(), coeff_nc


def cmd_train_pirender(args) -> int:
    import dataclasses

    import torch

    from ..infra.checkpoint import save_checkpoint
    from ..infra.device import resolve_device
    from ..models.pirender import FaceGenerator, PIRenderConfig
    from ..train.perceptual import ALL_TAPS, PerceptualLoss, Vgg19Features
    from ..train.pirender_trainer import PIRenderTrainer, make_pirender_optimizer
    from .run import load_net_g

    device = resolve_device(args.device)
    if args.tiny:
        cfg, taps, scales = PIRenderConfig.tiny(), ("relu_1_1", "relu_2_1"), 1
    else:
        cfg, taps, scales = PIRenderConfig(), ALL_TAPS, 3
    raw, coeff_nc = pair_batches(args, cfg.coeff_nc)
    cfg = dataclasses.replace(cfg, coeff_nc=coeff_nc)
    gen = FaceGenerator.random_init(cfg, seed=args.seed, device=device).train()
    if args.net_g:
        gen.load_state_dict(load_net_g(args.net_g, cfg))
    vgg = Vgg19Features.random_init(taps, seed=1, device=device)

    disc = opt_d = None
    if args.gan:
        from ..models.discriminator import MultiscaleDiscriminator

        disc = MultiscaleDiscriminator.random_init(
            seed=2, device=device, num_d=1 if args.tiny else 2, ndf=8 if args.tiny else 64,
            n_layers=2 if args.tiny else 4)
        opt_d = torch.optim.Adam(disc.parameters(), lr=args.lr, betas=(0.5, 0.999), eps=1e-8)

    opt, sched = make_pirender_optimizer(gen.parameters(), args.lr)
    trainer = PIRenderTrainer(
        generator=gen, optimizer=opt, scheduler=sched,
        perceptual_warp=PerceptualLoss(vgg, layers=taps, num_scales=scales),
        perceptual_final=PerceptualLoss(vgg, layers=taps, num_scales=scales, use_style_loss=True),
        pretrain_warp_steps=args.warp_steps, discriminator=disc, optimizer_d=opt_d)

    t0 = time.time()
    metrics = {}
    for i in range(args.steps):
        batch = _nchw(next(raw), device)
        warp_only = i < args.warp_steps
        metrics = trainer.train_step(batch, warp_only, use_gan=disc is not None)
        if disc is not None and not warp_only:
            metrics = dict(metrics, gan_d=trainer.d_train_step(batch))
        if (i + 1) % args.log_every == 0:
            print(f"step {i + 1}: " + " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
                  + f" ({(i + 1) / (time.time() - t0):.1f} it/s)")
    if args.ckpt_dir:
        payload = {"net_G": gen.state_dict()}
        if disc is not None:
            payload["net_D"] = disc.state_dict()
        save_checkpoint(args.ckpt_dir, payload)
        print(f"saved -> {args.ckpt_dir}")
    print("final:", {k: round(float(v), 5) for k, v in metrics.items()})
    return 0


def register(sub, common):
    tp = sub.add_parser("train-pirender", help="PIRender reenactment training on video-pair data")
    tp.add_argument("--root", default=None,
                    help="EMOCA-preprocessed root with detection crops")
    tp.add_argument("--steps", type=int, default=200)
    tp.add_argument("--warp-steps", type=int, default=100,
                    help="warp-only pretrain steps (pretrain_warp_iteration)")
    tp.add_argument("--batch-size", type=int, default=4)
    tp.add_argument("--image-size", type=int, default=256)
    tp.add_argument("--lr", type=float, default=1e-4)
    tp.add_argument("--cross-id", action="store_true",
                    help="source image from another identity (VoxVideoDataset's "
                         "cross-reenactment sampling)")
    tp.add_argument("--gan", action="store_true",
                    help="hinge GAN + feature matching on the editing stage")
    tp.add_argument("--net-g", default=None, help="warm-start from a torch net_G checkpoint")
    tp.add_argument("--tiny", action="store_true")
    tp.add_argument("--seed", type=int, default=0)
    tp.add_argument("--ckpt-dir", default=None)
    tp.add_argument("--log-every", type=int, default=50)
    tp.add_argument("--device", default=None,
                    help="torch device; the default is the CUDA card, and no card is an error")
    tp.set_defaults(fn=cmd_train_pirender)
