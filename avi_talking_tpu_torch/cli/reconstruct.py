"""Asset tooling: ``convert-flame`` (the user's FLAME ``generic_model.pkl``
-> the npz ``--flame-npz`` reads) and ``stats`` (MEAD coefficient mean /
std). Host numpy only; JAX's ``reconstruct`` is still to port."""

from __future__ import annotations

import os


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
