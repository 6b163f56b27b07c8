"""Shared CLI helpers: pipeline assembly, output saving, common flags."""

from __future__ import annotations

import os
import sys


def _build_pipeline(args):
    from ..core.assets import default_assets_path, load_flame_assets, synthetic_assets
    from ..pipeline import AviTalkingPipeline, PipelineConfig

    if args.bf16:
        raise SystemExit("--bf16 is not ported to avi_talking_tpu_torch yet: "
                         "the port computes in float32")
    if args.checkpoint:
        raise SystemExit("--checkpoint is not ported to avi_talking_tpu_torch yet: "
                         "the port runs seeded random weights")
    if args.tiny:
        cfg = PipelineConfig.tiny()
        assets = synthetic_assets(n_shape=cfg.emote.n_shape, n_exp=cfg.emote.n_exp)
    else:
        cfg = PipelineConfig()
        npz = args.flame_npz or default_assets_path()
        assets = load_flame_assets(npz, cfg.emote.n_shape, cfg.emote.n_exp) if npz else None
        if assets is None:
            print(
                "[warn] no FLAME assets (set --flame-npz or AVI_TALKING_FLAME_NPZ); "
                "emitting exp/jaw coefficients only",
                file=sys.stderr,
            )
    return AviTalkingPipeline.random_init(cfg, flame_assets=assets, device=args.device)


def _save_outputs(out, out_dir: str, name: str, pipe, args) -> None:
    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    np.savez(
        os.path.join(out_dir, f"{name}_coeffs.npz"),
        exp=out["exp"],
        jaw=out["jaw"],
        style_emb=out["style_emb"],
    )
    if "vertices" in out and args.save_video:
        from ..viz import FlameVisualizer

        viz = FlameVisualizer(pipe.head.flame_assets.faces, image_size=args.image_size,
                              device=pipe.device)
        path = viz.visualize_verts(out["vertices"], os.path.join(out_dir, f"{name}.mp4"))
        print(f"  video: {path}")


def common_args(sp):
    """Flags shared by the product-pipeline commands."""
    sp.add_argument("--tiny", action="store_true", help="tiny test config")
    sp.add_argument("--bf16", action="store_true", help="bfloat16 compute (not ported yet)")
    sp.add_argument("--flame-npz", default=None)
    sp.add_argument("--checkpoint", default=None, help="(not ported yet)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--cond-scale", type=float, default=1.0)
    sp.add_argument("--out", default="outputs")
    sp.add_argument("--save-video", action="store_true")
    sp.add_argument("--image-size", type=int, default=256)
    sp.add_argument("--device", default=None,
                    help="torch device; the default is the CUDA card, and no card is an error")
