"""Product commands: generate / instruct / serve / diversity (the
experiments/diffusion_test.sh surface)."""

from __future__ import annotations

import os
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
