"""Product commands: generate / instruct / portrait / serve / diversity
(the experiments/diffusion_test.sh surface)."""

from __future__ import annotations

import os
import sys
import time

from ._common import _build_pipeline, _save_outputs


def cmd_generate(args) -> int:
    pipe = _build_pipeline(args)
    t0 = time.time()
    out = pipe.generate(args.wav, args.text, seed=args.seed, cond_scale=args.cond_scale)
    name = os.path.splitext(os.path.basename(args.wav))[0]
    _save_outputs(out, args.out, name, pipe, args)
    print(f"generate: {out['exp'].shape[0]} frames in {time.time()-t0:.2f}s "
          f"-> {args.out}/{name}_coeffs.npz")
    return 0


def cmd_instruct(args) -> int:
    from ..data import CaptionDataset

    ds = CaptionDataset(args.json_dir, args.wav_dir)
    pipe = _build_pipeline(args)
    times = []
    for item in ds:
        for ci, caption in enumerate(item.captions):
            t0 = time.time()
            out = pipe.generate(item.wav_path, caption, seed=args.seed)
            times.append(time.time() - t0)
            _save_outputs(out, args.out, f"{item.name}_cap{ci}", pipe, args)
            print(f"[{item.name}/{ci}] {caption[:60]!r} -> "
                  f"{out['exp'].shape[0]} frames ({times[-1]:.2f}s)")
    if times:
        print(f"avg per-sample wall time: {sum(times)/len(times):.3f}s")
    return 0


def load_net_g(path: str, cfg):
    """A reference ``net_G`` file -> the port's state dict: read with
    ``weights_only`` first, the whole pickle when that refuses it, then
    ``models.pirender.pirender_state_from_torch`` (``net_G_ema`` or
    ``state_dict`` unwrapped, ``module.`` stripped, the keys checked)."""
    import torch

    from ..models.pirender import pirender_state_from_torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # an older pickle that weights_only refuses
        obj = torch.load(path, map_location="cpu", weights_only=False)
    return pirender_state_from_torch(obj, cfg)


def cmd_portrait(args) -> int:
    """PIRender portrait video from generated coefficients (the reference's
    ``inference_flame.py`` / ``coef_control.py``): a source portrait and the
    ``generate`` coefficient npz (or a ``--control`` sweep) drive ``net_G``;
    the output is a ``[warp |] fake`` strip video. Frames render in chunks
    of ``--chunk``."""
    import dataclasses

    import numpy as np
    import torch

    from ..infra.device import resolve_device
    from ..models.pirender import FaceGenerator, PIRenderConfig
    from ..ops.resize import resize_image_hwc
    from ..pipeline.portrait import (PortraitRenderer, build_semantics, control_schedule,
                                     write_strip_video)
    from ..viz.pngio import read_png

    device = resolve_device(args.device)
    src_u8 = read_png(args.source)
    if src_u8.shape[-1] == 4:
        src_u8 = src_u8[..., :3]
    elif src_u8.shape[-1] in (1, 2):
        src_u8 = np.repeat(src_u8[..., :1], 3, axis=-1)
    src = src_u8.astype(np.float32) / 127.5 - 1.0
    S = args.image_size
    if src.shape[:2] != (S, S):
        src = resize_image_hwc(src, S)

    if args.control:
        n_exp = args.control_exp_dims
        base = np.zeros(n_exp + 9, np.float32)
        base[n_exp + 6:] = np.asarray(args.cam, np.float32)
        descr, legs = control_schedule(base, num=args.control_steps)
        name = "control"
        print(f"control sweep: {len(legs)} legs, {descr.shape[0]} frames")
    else:
        if not args.coeffs:
            raise SystemExit("portrait needs --coeffs (or --control)")
        npz = np.load(args.coeffs)
        descr = build_semantics(npz["exp"], npz["jaw"], cam=np.asarray(args.cam, np.float32))
        name = os.path.splitext(os.path.basename(args.coeffs))[0]

    cfg = PIRenderConfig.tiny() if args.tiny else PIRenderConfig()
    cfg = dataclasses.replace(cfg, coeff_nc=int(descr.shape[-1]))
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    gen = FaceGenerator.random_init(cfg, seed=args.seed, device=device, dtype=dtype)
    if args.net_g:
        if cfg.coeff_nc != 59:
            raise SystemExit(f"--net-g expects the 59-d FLAME descriptor (exp50), got "
                             f"{cfg.coeff_nc}-d coeffs")
        gen.load_state_dict(load_net_g(args.net_g, cfg))
    else:
        print("portrait: RANDOM-init net_G (smoke semantics; pass --net-g for real renders)",
              file=sys.stderr)

    renderer = PortraitRenderer(gen, chunk=args.chunk)
    t0 = time.time()
    out = renderer.render(src, descr, return_warp=args.save_warp)
    streams = [out["warp"], out["fake"]] if args.save_warp else [out["fake"]]
    os.makedirs(args.out, exist_ok=True)
    path = write_strip_video(os.path.join(args.out, f"{name}_portrait.mp4"), *streams,
                             audio_path=args.wav)
    print(f"portrait: {descr.shape[0]} frames in {time.time()-t0:.2f}s -> {path}")
    return 0


def cmd_serve(args) -> int:
    """Serve the caption corpus through the micro-batching InferenceServer
    (the serving counterpart of ``instruct``'s per-sample loop)."""
    from ..data import CaptionDataset
    from ..pipeline.server import InferenceServer, ServingConfig

    ds = CaptionDataset(args.json_dir, args.wav_dir)
    pipe = _build_pipeline(args)
    scfg = ServingConfig(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        batch_buckets=tuple(sorted({args.max_batch} | {
            b for b in (1, 2, 4, 8, 16, 32) if b <= args.max_batch})),
        length_buckets=tuple(args.length_buckets),
        return_vertices=args.save_video,  # meshes only when rendering
    )
    t0 = time.time()
    with InferenceServer(pipe, scfg) as server:
        if args.warmup:
            server.warmup()
            print(f"warmup: {time.time()-t0:.1f}s "
                  f"({len(scfg.batch_buckets)}x{len(scfg.length_buckets)} shapes)")
        futs = []
        t1 = time.time()
        for item in ds:
            for ci, caption in enumerate(item.captions):
                futs.append((f"{item.name}_cap{ci}",
                             server.submit(item.wav_path, caption, seed=args.seed)))
        audio_s = 0.0
        for name, fut in futs:
            out = fut.result()
            audio_s += out["exp"].shape[0] / 25.0
            _save_outputs(out, args.out, name, pipe, args)
        wall = time.time() - t1
        pct = server.latency_percentiles()
        occ = server.stats["batch_size"]
        print(
            f"served {len(futs)} requests ({audio_s:.1f}s audio) in {wall:.2f}s "
            f"({audio_s / wall:.1f}x realtime); latency p50 {pct['p50']:.0f}ms "
            f"p99 {pct['p99']:.0f}ms; mean batch {sum(occ)/len(occ):.1f}"
        )
    return 0


def diversity_score(pipe, text: str, num_samples: int, seed: int = 0, noise=None) -> float:
    """Mean pairwise L2 distance of ``num_samples`` styles sampled for
    ``text``, sample i from a generator seeded ``seed + i`` (or from
    ``noise[i]``, the prior's explicit draws), as JAX's ``diversity`` draws
    sample i from ``PRNGKey(seed + i)`` at ``cond_scale`` 1."""
    import torch

    from ..train.eval_metrics import style_diversity

    embs = [pipe.sample_style(text, seed=seed + i, noise=None if noise is None else noise[i])[0]
            for i in range(num_samples)]
    return float(style_diversity(torch.stack(embs).float()))


def cmd_diversity(args) -> int:
    """Style diversity (the reference's ``--is_cal_diversity``): sample N
    style embeddings for one instruction and report their mean pairwise L2
    distance."""
    pipe = _build_pipeline(args)
    score = diversity_score(pipe, args.text, args.num_samples, args.seed)
    print(f"diversity over {args.num_samples} samples: {score:.4f}")
    return 0


def register(sub, common):
    g = sub.add_parser("generate", help="single wav + instruction")
    g.add_argument("--wav", required=True)
    g.add_argument("--text", required=True)
    common(g)
    g.set_defaults(fn=cmd_generate)

    i = sub.add_parser("instruct", help="caption-corpus batch inference")
    i.add_argument("--json-dir", required=True)
    i.add_argument("--wav-dir", default=None)
    common(i)
    i.set_defaults(fn=cmd_instruct)

    pt = sub.add_parser("portrait", help="PIRender photoreal portrait video from generated coeffs")
    pt.add_argument("--source", required=True, help="source portrait PNG (identity to reenact)")
    pt.add_argument("--coeffs", default=None, help="coeff npz from `generate` (exp, jaw)")
    pt.add_argument("--net-g", default=None, help="PIRender net_G torch checkpoint (.pt)")
    pt.add_argument("--wav", default=None, help="audio to mux into the video")
    pt.add_argument("--cam", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                    help="fixed camera semantic (3 floats)")
    pt.add_argument("--chunk", type=int, default=32, help="frames per net_G forward")
    pt.add_argument("--save-warp", action="store_true",
                    help="write a warp|fake strip instead of fake only")
    pt.add_argument("--control", action="store_true",
                    help="render a semantic control sweep instead of coeffs")
    pt.add_argument("--control-steps", type=int, default=10)
    pt.add_argument("--control-exp-dims", type=int, default=50)
    common(pt)
    pt.set_defaults(fn=cmd_portrait)

    sv = sub.add_parser("serve", help="micro-batched serving over a corpus")
    sv.add_argument("--json-dir", required=True)
    sv.add_argument("--wav-dir", default=None)
    sv.add_argument("--max-batch", type=int, default=8)
    sv.add_argument("--max-wait-ms", type=float, default=5.0)
    sv.add_argument("--length-buckets", type=int, nargs="+", default=[64, 128, 256, 512])
    sv.add_argument("--warmup", action="store_true")
    common(sv)
    sv.set_defaults(fn=cmd_serve)

    dv = sub.add_parser("diversity", help="style diversity score (N samples)")
    dv.add_argument("--text", required=True)
    dv.add_argument("--num-samples", type=int, default=10)
    common(dv)
    dv.set_defaults(fn=cmd_diversity)
