"""screen-videos: CelebV-Text screening (port of
``avi_talking_tpu/cli/screen_videos.py``; host logic, ``data.celebv``).

Videos and CelebV annotations in, a selections JSON out: one row per
(video, action) with the clip-relative interval to cut. ``--curated``
filters by the packaged hand-curated action table
(``data/assets/celebv_actions.json``) instead. The command runs on the
host; ``--device`` follows the port's rule all the same (the card unless
``--device cpu``, and no card is an error)."""

from __future__ import annotations

import json
import os
import sys


def cmd_screen_videos(args) -> int:
    from ..infra.device import resolve_device

    resolve_device(args.device)
    from ..data.celebv import (
        SIGNIFICANT_ACTIONS,
        filter_curated,
        load_action_table,
        screen_videos,
    )

    if os.path.isdir(args.src):
        exts = (".mp4", ".avi", ".mov", ".mkv", ".webm")
        names = sorted(f for f in os.listdir(args.src)
                       if f.lower().endswith(exts))
    else:  # a text file of one video name per line
        with open(args.src) as f:
            names = [ln.strip() for ln in f if ln.strip()]
    if not names:
        print("screen-videos: no videos found under --src", file=sys.stderr)
        return 1

    if args.curated:
        table = load_action_table(args.table) if args.table \
            else load_action_table()
        rows = [{"video": n, "action": a}
                for n, a in filter_curated(names, table)]
    else:
        if not (args.annotations and args.clip_info):
            raise SystemExit("screen-videos needs --annotations + "
                             "--clip-info (or --curated)")
        if args.annotations.endswith(".json"):
            with open(args.annotations) as f:
                ann = json.load(f)
        else:  # CelebV ships annotations.pkl
            import pickle

            with open(args.annotations, "rb") as f:
                ann = pickle.load(f)
        with open(args.clip_info) as f:
            clip_info = json.load(f)
        actions = (tuple(args.actions.split(","))
                   if args.actions else SIGNIFICANT_ACTIONS)
        rows = screen_videos(names, ann["act"], clip_info,
                             significant_actions=actions,
                             max_per_action=args.max_per_action)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    per_action: dict = {}
    for r in rows:
        per_action[r["action"]] = per_action.get(r["action"], 0) + 1
    print(f"selected {len(rows)} rows over {len(per_action)} actions "
          f"-> {args.out}")
    for k in sorted(per_action):
        print(f"  {k}: {per_action[k]}")
    return 0


def register(sub, common) -> None:
    sv = sub.add_parser(
        "screen-videos",
        help="CelebV-Text screening: select expressive clips + action "
             "intervals (celebv_screen_videos.py)")
    sv.add_argument("--src", required=True,
                    help="video directory, or a text file of video names")
    sv.add_argument("--out", required=True, help="selections JSON path")
    sv.add_argument("--annotations", default=None,
                    help="CelebV temporal annotations (annotations.pkl or "
                         "a JSON with the same {'act': ...} layout)")
    sv.add_argument("--clip-info", default=None,
                    help="celebvtext_info.json (per-clip duration info)")
    sv.add_argument("--actions", default=None,
                    help="comma list of significant actions "
                         "(default: the reference's 15)")
    sv.add_argument("--max-per-action", type=int, default=500,
                    help="per-action selection quota (reference 500)")
    sv.add_argument("--curated", action="store_true",
                    help="filter by the shipped hand-curated action table "
                         "instead of screening annotations")
    sv.add_argument("--table", default=None,
                    help="override the packaged celebv_actions.json")
    sv.add_argument("--device", default=None,
                    help="torch device; the default is the CUDA card, and no card is an error")
    sv.set_defaults(fn=cmd_screen_videos)
