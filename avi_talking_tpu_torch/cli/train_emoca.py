"""train-emoca: EMOCA / DECA self-supervised training over an image folder
(the reference's EMOCA training stage, ``train.emoca_trainer``): the
coarse stage (``--exp-only``: EMOCA's expression tower alone; ``--emo-loss``:
the emotion-consistency term through a frozen EmoNet) or the detail stage
(``--detail``: ``E_detail`` and the displacement generator on the frozen
coarse pipeline).

``--root`` is a folder of PNG frames with ``landmarks.npy`` (68 points in
[-1, 1]; ``--lmk-npy`` names another file), or an EMOCA-preprocessed clip
(``EMOCA_v2_lr_mse_20/`` beside ``detections/*.png``); ``masks/`` is read
only when it covers every frame. Without ``--root`` it trains on synthetic
batches. Checkpoints (``--checkpoint``, ``--ckpt-dir``) are the port's own
(``infra.checkpoint``): ``{"encoder": ..., "generator": ...}`` state dicts;
a coarse checkpoint given to ``--detail`` is grafted into the detail
stage's encoder."""

from __future__ import annotations

import os
import sys


def uv_assets(uv_obj, assets):
    """(uv_coords (Tv, 2), uv_faces (F, 3)): ``--uv-obj``'s UVs, or the
    template's planar projection onto x / y."""
    import numpy as np
    import torch

    if uv_obj:
        from ..viz.meshio import read_obj

        mesh = read_obj(uv_obj)
        return (torch.from_numpy(mesh.uvs),
                torch.from_numpy(mesh.face_uvs if mesh.face_uvs is not None else mesh.faces))
    t = assets.v_template.detach().cpu().numpy()
    span = t.max(0) - t.min(0) + 1e-6
    return torch.from_numpy(((t - t.min(0)) / span)[:, :2].astype(np.float32)), assets.faces


def _decode_frames(paths, idx, size):
    """Frames ``idx`` of ``paths`` as (N, size, size, 3) float32 in [0, 1],
    resized as ``jax.image.resize`` resizes where the height differs."""
    import numpy as np
    import torch

    from ..train.deca_losses import resize_bilinear
    from ..viz.pngio import read_image_normalized

    imgs = np.stack([read_image_normalized(paths[j]) for j in idx]) * 0.5 + 0.5
    if imgs.shape[1] != size:
        imgs = resize_bilinear(torch.from_numpy(imgs), size, size).numpy()
    return imgs


def batch_source(args, device):
    """Endless batches {"images" (B, S, S, 3), "lmk" (B, 68, 2), "masks"
    (B, S, S, 1) where the folder has them}, on ``device``."""
    import glob

    import numpy as np
    import torch

    S, B = args.size, args.batch_size
    rng = np.random.default_rng(args.seed)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    if not args.root:
        print("train-emoca: no --root; synthetic image batches (smoke)", file=sys.stderr)

        def synthetic():
            while True:
                yield {"images": dev(rng.uniform(0, 1, (B, S, S, 3))),
                       "lmk": dev(rng.uniform(-0.8, 0.8, (B, 68, 2)))}
        return synthetic()

    if os.path.isdir(os.path.join(args.root, "EMOCA_v2_lr_mse_20")):
        paths = sorted(glob.glob(os.path.join(args.root, "detections", "*.png")))
    else:
        paths = sorted(glob.glob(os.path.join(args.root, "*.png")))
    if not paths:
        raise SystemExit(f"no PNG frames under {args.root}")
    lmk_path = args.lmk_npy or os.path.join(args.root, "landmarks.npy")
    lmk = None
    if os.path.exists(lmk_path):
        lmk = np.load(lmk_path).astype(np.float32)  # (N, 68, 2) in [-1, 1]
        if lmk.shape[0] != len(paths):
            raise SystemExit(f"landmarks ({lmk.shape[0]}) != frames ({len(paths)})")
    elif not args.detail:  # the detail stage never reads landmarks
        raise SystemExit(f"train-emoca needs 68-point landmarks ({lmk_path}); run a detector "
                         "offline or export from the EMOCA folders")
    mask_paths = [os.path.join(args.root, "masks", os.path.basename(p)) for p in paths]
    n_masks = sum(os.path.exists(m) for m in mask_paths)
    have_masks = n_masks == len(paths)
    if 0 < n_masks < len(paths):
        print(f"train-emoca: masks/ covers {n_masks}/{len(paths)} frames — IGNORING masks, "
              "photometric loss falls back to render alpha", file=sys.stderr)

    def frames():
        while True:
            idx = rng.integers(0, len(paths), size=B)
            b = {"images": dev(_decode_frames(paths, idx, S))}
            if lmk is not None:
                b["lmk"] = dev(lmk[idx])
            if have_masks:
                b["masks"] = dev(_decode_frames(mask_paths, idx, S)[..., :1] > 0.5)
            yield b
    print(f"data root: {len(paths)} frames (per-batch decode{', seg masks' if have_masks else ''})")
    return frames()


def _load_encoder(enc, path: str, detail: bool) -> None:
    """``--checkpoint``'s encoder into ``enc``: the whole state, or for the
    detail stage a coarse checkpoint's towers grafted beside a fresh
    ``E_detail`` (DECA trains the detail stage on a pretrained coarse one)."""
    from ..infra.checkpoint import own_state, restore_checkpoint

    state = restore_checkpoint(path)["encoder"]
    if detail and not any(k.startswith("E_detail.") for k in state):
        for name in ("E_flame", "E_expression"):
            tower = getattr(enc, name)
            tower.load_state_dict(own_state(tower, state, name + "."))
        print("train-emoca --detail: grafted coarse checkpoint into the detail-stage tree",
              file=sys.stderr)
    else:
        enc.load_state_dict(own_state(enc, state))


def cmd_train_emoca(args) -> int:
    import torch

    from ..core.assets import default_assets_path, load_flame_assets, synthetic_assets
    from ..core.flame import FlameModel, FlameTex
    from ..infra.checkpoint import load_frozen_tower, restore_checkpoint, save_checkpoint
    from ..infra.device import resolve_device
    from ..infra.init import random_module
    from ..models.emoca import EmocaEncoder, EmoNetLoss, EmotionRecognitionModule
    from ..train.deca_losses import DecaLossWeights
    from ..train.emoca_trainer import DecaDetailTrainer, EmocaTrainer, train_emoca

    device = resolve_device(args.device)
    S = args.size
    if args.tiny:
        assets = synthetic_assets(n_shape=8, n_exp=6, n_static_landmarks=51)
        n_shape, n_exp = 8, 6
    else:
        npz = args.flame_npz or default_assets_path()
        if not npz:
            raise SystemExit("train-emoca needs FLAME assets (--flame-npz)")
        n_shape, n_exp = 100, 50
        assets = load_flame_assets(npz, n_shape, n_exp)
    flame = FlameModel(assets.to(device), n_shape=n_shape, n_exp=n_exp)
    uv_coords, uv_faces = (t.to(device) for t in uv_assets(args.uv_obj, assets))
    ftex = FlameTex.from_npz(args.tex_npz).to(device) if args.tex_npz else None
    if ftex is None:
        print("train-emoca: no --tex-npz; flat grey albedo (albedo regularizers become "
              "near-no-ops)", file=sys.stderr)

    n_detail = 4 if args.tiny else 128
    enc = random_module(lambda: EmocaEncoder(n_exp=n_exp, with_detail=args.detail,
                                             n_detail=n_detail),
                        device, torch.Generator().manual_seed(args.seed))
    if args.checkpoint:
        _load_encoder(enc, args.checkpoint, args.detail)
    batches = batch_source(args, device)

    if args.detail:
        from ..models.deca_detail import DecaDetailModel, DetailGenerator

        if args.exp_only or args.emo_loss or args.emonet_checkpoint:
            print("train-emoca --detail: --exp-only/--emo-loss/--emonet-checkpoint are "
                  "coarse-stage flags and are IGNORED by the detail stage", file=sys.stderr)
        gen = DetailGenerator.random_init(3 + n_exp + n_detail, init_size=2 if args.tiny else 8,
                                          seed=args.seed + 1, device=device)
        if args.checkpoint and "generator" in restore_checkpoint(args.checkpoint):
            gen.load_state_dict(restore_checkpoint(args.checkpoint)["generator"])
        dm = DecaDetailModel(generator=gen, faces=flame.assets.faces, uv_coords=uv_coords,
                             uv_faces=uv_faces, uv_size=64 if args.tiny else 256)
        trainer = DecaDetailTrainer(encoder=enc, detail_model=dm, flame=flame, flame_tex=ftex,
                                    image_size=S)

        def log(step, vals):
            print(f"step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in vals.items()))
        metrics = train_emoca(trainer, batches, args.steps, args.lr, args.log_every, log)
        state = {"encoder": enc.state_dict(), "generator": gen.state_dict()}
    else:
        emonet = None
        if args.emo_loss:
            emo = random_module(lambda: EmotionRecognitionModule(n_expression=8), device,
                                torch.Generator().manual_seed(9)).requires_grad_(False)
            if args.emonet_checkpoint:
                load_frozen_tower(emo, args.emonet_checkpoint)
            else:
                print("train-emoca: no --emonet-checkpoint; the frozen EmoNet is RANDOM-init "
                      "(smoke semantics)", file=sys.stderr)
            emonet = EmoNetLoss(emo)
        trainer = EmocaTrainer(encoder=enc, flame=flame, uv_coords=uv_coords, uv_faces=uv_faces,
                               flame_tex=ftex, image_size=S,
                               weights=DecaLossWeights(emonet=1.0 if args.emo_loss else 0.0),
                               train_exp_only=args.exp_only, emonet=emonet)
        metrics = train_emoca(trainer, batches, args.steps, args.lr, args.log_every)
        state = {"encoder": enc.state_dict()}
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, state)
        print(f"saved encoder -> {args.ckpt_dir}")
    print("final:", {k: round(v, 5) for k, v in metrics.items()})
    return 0


def register(sub, common):
    tm = sub.add_parser("train-emoca",
                        help="EMOCA coarse self-supervised training over an image folder")
    tm.add_argument("--root", default=None,
                    help="folder of face PNGs + landmarks.npy (68pt, [-1,1])")
    tm.add_argument("--lmk-npy", default=None,
                    help="explicit landmarks npy path (default <root>/landmarks.npy)")
    tm.add_argument("--steps", type=int, default=200)
    tm.add_argument("--batch-size", type=int, default=8)
    tm.add_argument("--size", type=int, default=224, help="train image resolution")
    tm.add_argument("--lr", type=float, default=1e-4)
    tm.add_argument("--exp-only", action="store_true",
                    help="freeze the coarse tower; train only E_expression (the EMOCA staging)")
    tm.add_argument("--detail", action="store_true",
                    help="DETAIL stage: train E_detail + D_detail with the displacement losses "
                         "(frozen coarse pipeline)")
    tm.add_argument("--emo-loss", action="store_true",
                    help="EMOCA emotion-consistency loss through a frozen EmoNet "
                         "(use_emonet_loss)")
    tm.add_argument("--emonet-checkpoint", default=None,
                    help="torch EmotionRecognition ckpt for the frozen EmoNet tower "
                         "(random-init without it)")
    tm.add_argument("--uv-obj", default=None, help="head_template.obj for real FLAME UVs")
    tm.add_argument("--tex-npz", default=None, help="FLAME texture npz (PCA albedo)")
    tm.add_argument("--tiny", action="store_true")
    tm.add_argument("--flame-npz", default=None)
    tm.add_argument("--checkpoint", default=None,
                    help="a checkpoint directory of this command to start from")
    tm.add_argument("--ckpt-dir", default=None)
    tm.add_argument("--seed", type=int, default=0)
    tm.add_argument("--log-every", type=int, default=50)
    tm.add_argument("--device", default=None,
                    help="torch device; the default is the CUDA card, and no card is an error")
    tm.set_defaults(fn=cmd_train_emoca)
