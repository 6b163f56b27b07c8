"""preprocess-mead and train-emoca.

preprocess-mead: raw frame folders (or videos, ``--videos``) -> the
EMOCA-preprocessed MEAD layout that the ``--root`` commands read
(``data.preprocess``): the EMOCA encoder's pseudo-GT codes, with FAN
landmarks (``--fan-ckpt`` / ``--fan-detect``), the full-frame face crop
(``--full-frames``, with S3FD boxes first given ``--sfd-ckpt``) and
BiSeNet's photometric masks (``--bisenet-ckpt`` / ``--parse-faces``).
Without weights each net is seeded random ("RANDOM-init" on stderr).

train-emoca: EMOCA / DECA self-supervised training over an image folder
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


_EMOCA_PREFIXES = ("deca.", "model.", "")


def _preprocess_encoder(args, device):
    """The EMOCA encoder of preprocess-mead: seeded (seed 0), then
    ``--checkpoint``'s weights: a port checkpoint directory (its
    ``encoder``, as reconstruct reads it) or a reference torch file, its
    towers found under ``deca.`` / ``model.`` / no prefix."""
    import torch

    from ..infra.checkpoint import load_torch_state_dict, own_state, restore_checkpoint
    from ..infra.init import random_module
    from ..models.emoca import EmocaEncoder, emoca_encoder_state_from_torch

    enc = random_module(lambda: EmocaEncoder(n_exp=6 if args.tiny else 50), device,
                        torch.Generator().manual_seed(0))
    if not args.checkpoint:
        print("preprocess-mead: no --checkpoint; EMOCA encoder is RANDOM-init (smoke "
              "semantics — codes are meaningless)", file=sys.stderr)
    elif os.path.isdir(args.checkpoint):
        enc.load_state_dict(own_state(enc, restore_checkpoint(args.checkpoint)["encoder"]))
    else:
        sd = load_torch_state_dict(args.checkpoint)
        pref = next((c for c in _EMOCA_PREFIXES if any(k.startswith(c + "E_flame.") for k in sd)),
                    "")
        enc.load_state_dict(emoca_encoder_state_from_torch(sd, prefix=pref))
    return enc


def _seeded(factory, device, seed, ckpt=None, importer=None):
    """``factory()`` on ``device`` with seeded weights, or ``ckpt``'s through
    ``importer`` (a ``*_state_from_torch``)."""
    import torch

    from ..infra.checkpoint import load_torch_state_dict
    from ..infra.init import random_module

    module = random_module(factory, device, torch.Generator().manual_seed(seed))
    if ckpt:
        module.load_state_dict(importer(load_torch_state_dict(ckpt)))
    return module


def preprocess_nets(args, device):
    """(EmocaPreprocessor, FAN detector or None, BiSeNet parser or None,
    S3FD detector or None, FLAME or None) for preprocess-mead's flags."""
    from ..data.preprocess import EmocaPreprocessor

    pre = EmocaPreprocessor(encoder=_preprocess_encoder(args, device), max_b=args.max_b)
    detector = None
    if args.fan_ckpt or args.fan_detect:
        from ..models.fan_landmarks import (FanLandmarkDetector, FanLandmarkNet,
                                            fan_landmarks_state_from_torch)

        if args.fan_ckpt:
            fan = _seeded(FanLandmarkNet, device, 1, args.fan_ckpt,
                          fan_landmarks_state_from_torch)
            fan_size = 256  # 2DFAN4's depth-4 hourglass needs 256 px inputs
        else:
            print("preprocess-mead: --fan-detect without --fan-ckpt; FAN is RANDOM-init "
                  "(smoke semantics)", file=sys.stderr)
            fan = _seeded(lambda: FanLandmarkNet(num_modules=1, depth=2, stem_features=8,
                                                 features=16), device, 1)
            fan_size = None  # the tiny net takes any size divisible by 4
        detector = FanLandmarkDetector(fan, max_b=args.max_b, input_size=fan_size)
    if args.full_frames and detector is None:
        raise SystemExit("--full-frames needs --fan-ckpt or --fan-detect")
    parser = None
    if args.bisenet_ckpt or args.parse_faces:
        from ..models.bisenet import BiSeNet, FaceParser, bisenet_state_from_torch

        if not args.bisenet_ckpt:
            print("preprocess-mead: --parse-faces without --bisenet-ckpt; BiSeNet is "
                  "RANDOM-init (smoke semantics)", file=sys.stderr)
        net = _seeded(BiSeNet, device, 2, args.bisenet_ckpt, bisenet_state_from_torch)
        parser = FaceParser(net, size=512 if args.bisenet_ckpt else 64, max_b=args.max_b)
    box_detector = None
    if args.sfd_ckpt:
        if not args.full_frames:
            raise SystemExit("--sfd-ckpt only applies with --full-frames")
        from ..models.sfd import S3FD, SfdDetector, sfd_state_from_torch

        box_detector = SfdDetector(_seeded(S3FD, device, 3, args.sfd_ckpt, sfd_state_from_torch),
                                   threshold=args.sfd_threshold)
    flame = None
    if args.tiny or args.flame_npz:
        from ..core.assets import load_flame_assets, synthetic_assets
        from ..core.flame import FlameModel

        if args.tiny:
            flame = FlameModel(synthetic_assets(n_shape=8, n_exp=6, n_static_landmarks=51
                                                ).to(device), n_shape=8, n_exp=6)
        else:
            flame = FlameModel(load_flame_assets(args.flame_npz, 100, 50).to(device),
                               n_shape=100, n_exp=50)
    return pre, detector, parser, box_detector, flame


def cmd_preprocess_mead(args) -> int:
    """Raw frame folders -> the EMOCA-preprocessed MEAD layout (the
    reference's MEADDataModule / EmocaPreprocessor offline pass)."""
    from ..data.preprocess import preprocess_clip_folder, preprocess_clip_video
    from ..infra.device import resolve_device

    device = resolve_device(args.device)
    pre, detector, parser, box_detector, flame = preprocess_nets(args, device)
    opts = dict(write_detections=not args.no_detections, flame=flame, detector=detector,
                crop_full_frames=args.full_frames, crop_size=args.size,
                crop_scale=args.crop_scale, crop_smooth_sigma=args.crop_smooth_sigma,
                box_detector=box_detector, parser=parser)
    if args.videos:
        from ..data.videoio import have_ffmpeg

        if not have_ffmpeg():
            raise SystemExit("preprocess-mead --videos: ffmpeg not found on PATH — video "
                             "decode needs it; extract frames to PNG folders and re-run "
                             "without --videos")
        exts = (".mp4", ".avi", ".mov", ".mkv", ".webm")
        clips = sorted(f for f in os.listdir(args.src) if f.lower().endswith(exts)
                       and os.path.isfile(os.path.join(args.src, f)))
        runner = lambda clip: preprocess_clip_video(
            pre, os.path.join(args.src, clip), args.out,
            fps=args.fps if args.fps > 0 else None, **opts)
    else:
        clips = sorted(d for d in os.listdir(args.src)
                       if os.path.isdir(os.path.join(args.src, d)))
        runner = lambda clip: preprocess_clip_folder(pre, os.path.join(args.src, clip),
                                                     args.out, **opts)
    done = 0
    for clip in clips:
        out = runner(clip)
        if out:
            done += 1
            print(f"[{done}/{len(clips)}] {clip} -> {out}")
    print(f"preprocessed {done}/{len(clips)} clips -> {args.out}")
    return 0 if done else 1


def _register_preprocess(sub):
    pm = sub.add_parser("preprocess-mead",
                        help="raw frame folders -> EMOCA-preprocessed MEAD layout")
    pm.add_argument("--src", required=True,
                    help="root of <clip>/*.png (+ optional <clip>/*.wav, validity.npy), or of "
                         "video files with --videos")
    pm.add_argument("--out", required=True)
    pm.add_argument("--videos", action="store_true",
                    help="treat --src entries as VIDEO FILES (mp4/avi/...): decode through an "
                         "ffmpeg rawvideo pipe (data.videoio), demux audio to 16 kHz wav")
    pm.add_argument("--fps", type=float, default=25.0,
                    help="with --videos: resample to this frame rate (reference trains at 25 "
                         "fps); <=0 keeps source")
    pm.add_argument("--checkpoint", default=None,
                    help="EMOCA encoder weights: a checkpoint directory or a torch ckpt")
    pm.add_argument("--size", type=int, default=224)
    pm.add_argument("--max-b", type=int, default=32, help="frames per encoder call")
    pm.add_argument("--no-detections", action="store_true",
                    help="skip writing detections/*.png crops")
    pm.add_argument("--flame-npz", default=None,
                    help="FLAME assets: also export pseudo landmarks.npy per clip (train-emoca "
                         "--root fine-tune source)")
    pm.add_argument("--fan-ckpt", default=None,
                    help="face_alignment 2DFAN4 torch weights: detect landmarks + per-frame "
                         "validity")
    pm.add_argument("--fan-detect", action="store_true",
                    help="run the FAN detector even without weights (random-init smoke)")
    pm.add_argument("--full-frames", action="store_true",
                    help="source PNGs are FULL video frames: detect + warp-crop the face box "
                         "to --size before encoding (requires --fan-ckpt or --fan-detect)")
    pm.add_argument("--crop-scale", type=float, default=1.25,
                    help="face-box scale for --full-frames (reference 1.25)")
    pm.add_argument("--crop-smooth-sigma", type=float, default=3.0,
                    help="gaussian smoothing of the face-box track over time (reference "
                         "sigma=3; 0 disables); interpolates over failed detections first")
    pm.add_argument("--sfd-ckpt", default=None,
                    help="S3FD torch weights: stage-1 face-box detection before FAN (for "
                         "frames where the face does not dominate); requires --full-frames")
    pm.add_argument("--sfd-threshold", type=float, default=0.5,
                    help="S3FD keep threshold (reference filter_threshold)")
    pm.add_argument("--bisenet-ckpt", default=None,
                    help="face-parsing BiSeNet torch weights: write photometric masks/ per "
                         "clip (train-emoca useSeg)")
    pm.add_argument("--parse-faces", action="store_true",
                    help="run the face parser even without weights (random-init smoke)")
    pm.add_argument("--tiny", action="store_true")
    pm.add_argument("--device", default=None,
                    help="torch device; the default is the CUDA card, and no card is an error")
    pm.set_defaults(fn=cmd_preprocess_mead)


def register(sub, common):
    _register_preprocess(sub)
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
