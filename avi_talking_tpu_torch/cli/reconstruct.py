"""EMOCA reconstruction and asset tooling: ``reconstruct`` (image(s) ->
EMOCA codes -> FLAME -> shaded, textured and detail renders),
``convert-flame`` (the user's FLAME ``generic_model.pkl`` -> the npz
``--flame-npz`` reads) and ``stats`` (MEAD coefficient mean / std)."""

from __future__ import annotations

import os
import sys

# the reconstruction's fixed camera [scale, tx, ty]
RECONSTRUCT_CAM = (8.0, 0.0, -0.01)
_DETAIL_PREFIXES = ("D_detail.", "deca.D_detail.", "model.D_detail.")


def _u8(img):
    import numpy as np

    return (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)


def _detail_weights(gen, path: str) -> None:
    """``--detail-checkpoint``: a port checkpoint directory (its
    ``generator``), or a torch EMOCA / DECA file whose ``D_detail`` prefix
    is found as JAX finds it."""
    from ..infra.checkpoint import load_torch_state_dict, restore_checkpoint
    from ..models.deca_detail import detail_generator_state_from_torch

    if os.path.isdir(path):
        gen.load_state_dict(restore_checkpoint(path)["generator"])
        return
    sd = load_torch_state_dict(path)
    pref = next((c for c in _DETAIL_PREFIXES if any(k.startswith(c) for k in sd)), "")
    gen.load_state_dict(detail_generator_state_from_torch(sd, pref))


def reconstruct_frames(args, x, device):
    """(N, H, W, 3) images in [0, 1] on ``device`` -> (codes, vertices,
    shaded (N, S, S, 3), textured or None, UV detail normals or None), as
    JAX's ``cmd_reconstruct`` computes them."""
    import torch

    from ..core.assets import default_assets_path, load_flame_assets, synthetic_assets
    from ..core.flame import FlameModel, FlameTex
    from ..core.projection import batch_orth_proj
    from ..infra.checkpoint import own_state, restore_checkpoint
    from ..infra.init import random_module
    from ..models.emoca import EmocaEncoder
    from ..viz.shading import render_shaded, render_textured
    from .train_emoca import uv_assets

    n_shape, n_exp = (8, 6) if args.tiny else (100, 50)
    n_detail = 4 if args.tiny else 128
    # the full-size code layout (236 + 50), E_detail on request
    enc = random_module(lambda: EmocaEncoder(with_detail=args.detail, n_detail=n_detail),
                        device, torch.Generator().manual_seed(0))
    if args.checkpoint:  # a train-emoca checkpoint directory
        enc.load_state_dict(own_state(enc, restore_checkpoint(args.checkpoint)["encoder"]))
    xs = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        chunks = [enc(xs[i:i + 8]) for i in range(0, xs.shape[0], 8)]  # EmocaPreprocessor's max_b
    codes = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
    if args.tiny:  # onto the synthetic assets' PCA dims
        codes = {**codes, "shape": codes["shape"][:, :n_shape], "exp": codes["exp"][:, :n_exp]}

    npz = args.flame_npz or default_assets_path()
    if args.tiny or not npz:
        assets = synthetic_assets(n_shape=n_shape, n_exp=n_exp)
    else:
        assets = load_flame_assets(npz, n_shape, n_exp)
    flame = FlameModel(assets.to(device), n_shape=n_shape, n_exp=n_exp)
    faces = flame.assets.faces
    pose = torch.cat([torch.zeros_like(codes["pose"][:, :3]), codes["pose"][:, 3:]], dim=1)
    with torch.no_grad():
        verts = flame.vertices_only(codes["shape"], codes["exp"], pose)
        proj = batch_orth_proj(verts, torch.tensor([RECONSTRUCT_CAM], device=device))
        ndc = torch.stack([proj[..., 0], -proj[..., 1], -proj[..., 2]], dim=-1)
        shaded = render_shaded(ndc, faces, args.size, args.size)
        textured = detail_maps = None
        if args.textured or args.detail:
            uv_coords, uv_faces = (t.to(device) for t in uv_assets(args.uv_obj, assets))
        if args.textured:  # EMOCA's predicted_images: PCA albedo + SH light
            if args.tex_npz:
                albedo = FlameTex.from_npz(args.tex_npz, n_tex=codes["tex"].shape[1]).to(device)(
                    codes["tex"])
            else:
                print("reconstruct --textured: no --tex-npz (the external FLAME texture "
                      "download); rendering flat grey albedo", file=sys.stderr)
                albedo = torch.full((x.shape[0], 8, 8, 3), 0.6, device=device)
            textured = render_textured(ndc, faces, uv_coords, uv_faces, albedo, args.size,
                                       args.size)
        if args.detail:
            from ..models.deca_detail import DecaDetailModel, DetailGenerator

            gen = DetailGenerator.random_init(3 + n_exp + n_detail,
                                              init_size=2 if args.tiny else 8, seed=1,
                                              device=device)
            if args.detail_checkpoint:
                _detail_weights(gen, args.detail_checkpoint)
            else:
                print("reconstruct --detail: no --detail-checkpoint given; the detail branch "
                      "runs with RANDOM weights (smoke path, normal maps are noise)",
                      file=sys.stderr)
            model = DecaDetailModel(generator=gen, faces=faces, uv_coords=uv_coords,
                                    uv_faces=uv_faces, uv_size=64 if args.tiny else 256)
            detail_maps, _ = model.decode(codes["pose"][:, 3:], codes["exp"], codes["detail"],
                                          verts)
    return codes, verts, shaded, textured, detail_maps


def cmd_reconstruct(args) -> int:
    """EMOCA-style reconstruction (gdl_apps/EMOCA's test_emoca_on_images /
    _on_video): ``--image`` is one PNG or a folder of frames. Seeded random
    weights unless ``--checkpoint`` / ``--detail-checkpoint`` give them."""
    import glob

    import numpy as np
    import torch

    from ..infra.device import resolve_device
    from ..viz.pngio import read_image_normalized, write_png

    device = resolve_device(args.device)
    if os.path.isdir(args.image):
        paths = sorted(glob.glob(os.path.join(args.image, "*.png")))
        if not paths:
            print(f"no PNG frames in {args.image}", file=sys.stderr)
            return 1
    else:
        paths = [args.image]
    imgs = np.stack([read_image_normalized(p) for p in paths]) * 0.5 + 0.5  # [0, 1]
    codes, verts, shaded, textured, detail_maps = reconstruct_frames(
        args, torch.from_numpy(imgs).to(device), device)

    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.image.rstrip("/")))[0]
    names = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    np.savez(os.path.join(args.out_dir, f"{base}_codes.npz"),
             **{k: v.cpu().numpy() for k, v in codes.items()}, vertices=verts.cpu().numpy())
    if detail_maps is not None:
        for fn, nm in zip(names, detail_maps.cpu().numpy()):
            write_png(os.path.join(args.out_dir, f"{fn}_detail_normals.png"), _u8(nm * 0.5 + 0.5))
    if textured is not None:
        for fn, frame in zip(names, textured.cpu().numpy()):
            write_png(os.path.join(args.out_dir, f"{fn}_textured.png"), _u8(frame))
    shaded = shaded.cpu().numpy()
    if len(paths) == 1:
        write_png(os.path.join(args.out_dir, f"{base}_geometry.png"), _u8(shaded[0]))
        print(f"wrote {base}_codes.npz + {base}_geometry.png to {args.out_dir}")
    else:
        for fn, frame in zip(names, shaded):
            write_png(os.path.join(args.out_dir, f"{fn}_geometry.png"), _u8(frame))
        print(f"wrote {base}_codes.npz + {len(paths)} geometry frames to {args.out_dir}")
    return 0


def cmd_stats(args) -> int:
    from ..data.mead import MeadEmocaDataset

    ds = MeadEmocaDataset(root=args.root)
    stats = ds.compute_stats(max_clips=args.max_clips)
    stats.save(args.mean_out, args.std_out)
    print(f"wrote {args.mean_out} / {args.std_out} from {len(ds)} clips")
    return 0


def cmd_convert_flame(args) -> int:
    from ..core.assets import convert_flame_pickle

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = convert_flame_pickle(args.pkl, args.out, args.lmk_embedding,
                               args.mediapipe_lmk_embedding)
    print(f"wrote {out}")
    return 0


def register(sub, common):
    rc = sub.add_parser("reconstruct", help="EMOCA single-image reconstruction")
    rc.add_argument("--image", required=True, help="input PNG, or a folder of PNG frames")
    rc.add_argument("--out-dir", default="out")
    rc.add_argument("--size", type=int, default=256)
    rc.add_argument("--tiny", action="store_true")
    rc.add_argument("--flame-npz", default=None)
    rc.add_argument("--checkpoint", default=None,
                    help="encoder weights: a train-emoca checkpoint directory")
    rc.add_argument("--detail", action="store_true",
                    help="also run the DECA detail displacement branch")
    rc.add_argument("--detail-checkpoint", default=None,
                    help="D_detail weights: a train-emoca --detail checkpoint directory or a "
                         "torch EMOCA ckpt (without it the detail branch is random-init)")
    rc.add_argument("--uv-obj", default=None, help="head_template.obj for real FLAME UVs")
    rc.add_argument("--textured", action="store_true",
                    help="also write SH-lit textured renders (EMOCA's predicted_images; PCA "
                         "albedo needs --tex-npz)")
    rc.add_argument("--tex-npz", default=None,
                    help="FLAME texture npz (mean + tex_dir/basis); without it --textured uses "
                         "a flat grey albedo")
    rc.add_argument("--device", default=None,
                    help="torch device; the default is the CUDA card, and no card is an error")
    rc.set_defaults(fn=cmd_reconstruct)
    s = sub.add_parser("stats", help="regenerate Mead coeff stats")
    s.add_argument("--root", required=True)
    s.add_argument("--mean-out", default="coeff_mean_Mead.npy")
    s.add_argument("--std-out", default="coeff_std_Mead.npy")
    s.add_argument("--max-clips", type=int, default=200)
    s.set_defaults(fn=cmd_stats)

    cf = sub.add_parser("convert-flame", help="FLAME generic_model.pkl -> npz")
    cf.add_argument("--pkl", required=True)
    cf.add_argument("--out", default="assets/flame.npz")
    cf.add_argument("--lmk-embedding", default=None)
    cf.add_argument("--mediapipe-lmk-embedding", default=None)
    cf.set_defaults(fn=cmd_convert_flame)
