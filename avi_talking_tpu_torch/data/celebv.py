"""CelebV-Text curated metadata and screening (port of
``avi_talking_tpu/data/celebv.py``; host logic, as in JAX).

The reference's two author scripts: a hand-curated table of 641 video ids
over 5 head-motion actions (``data/assets/celebv_actions.json``, a copy of
the JAX package's) and a screening pass that keeps videos whose CelebV
temporal annotations hold "significant" facial actions, with each action's
interval inside the clip, under a per-action quota.

  * ``load_action_table`` / ``video_to_action``: the curated id lists;
  * ``resolve_clip_id``: CelebV ids drift by leading '-' / '_'; one scan
    over the candidates the reference probes;
  * ``action_interval``: an 'HH:MM:SS' action start -> seconds relative to
    the clip's start_sec, clamped at 0, plus the action's duration;
  * ``screen_videos``: the selection loop (an action leaves the significant
    set once its quota is full);
  * ``filter_curated``: keep only the names in the curated table.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# celebv_screen_videos.py main(): the actions considered expressive enough
# to keep (sneeze is commented out there too)
SIGNIFICANT_ACTIONS: Tuple[str, ...] = (
    "wink", "turn", "sniff", "shake_head", "look_around", "nod", "laugh",
    "close_eyes", "smile", "blink", "sigh", "head_wagging", "glare",
    "frown", "gaze",
)

_ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "assets", "celebv_actions.json")


def load_action_table(path: Optional[str] = None) -> Dict[str, List[str]]:
    """{action: [video id, ...]} — the hand-curated head-dynamics subset
    (nod/look_around/head_wagging/turn/shake_head, 641 ids)."""
    with open(path or _ASSET) as f:
        return json.load(f)


def video_to_action(
    table: Optional[Dict[str, List[str]]] = None
) -> Dict[str, str]:
    """Invert the table: video id -> action (get_vid_name2action)."""
    table = table if table is not None else load_action_table()
    out: Dict[str, str] = {}
    for action, names in table.items():
        for name in names:
            out[name] = action
    return out


def strip_video_suffixes(name: str) -> str:
    """Video filename -> annotation id (basename minus .pkl/.mp4 layers —
    the reference sees artifacts like 'x.mp4.mp4')."""
    name = os.path.basename(name)
    while True:
        root, ext = os.path.splitext(name)
        if ext.lower() not in (".mp4", ".pkl", ".avi", ".mkv", ".webm",
                               ".mov", ".json"):
            return name
        name = root


def resolve_clip_id(act_annotations: Dict[str, list],
                    id_name: str) -> Optional[str]:
    """Find the annotation key for a (possibly dash-mangled) video id.

    CelebV ids may gain/lose leading '-'/'_' between the download tool and
    the annotation files; the reference tries the raw id, the stripped id
    and the stripped id re-prefixed with 1-3 dashes (celev_info.py:4-25).
    Returns None when no candidate exists (the reference would raise)."""
    if id_name in act_annotations:
        return id_name
    base = id_name.lstrip("_").lstrip("-")
    for cand in (base, "-" + base, "--" + base, "---" + base):
        if cand in act_annotations:
            return cand
    return None


def get_actions(act_annotations: Dict[str, list],
                id_name: str) -> Tuple[Optional[str], List[str]]:
    """(resolved id, [action names]) for one video (get_actions)."""
    ref_id = resolve_clip_id(act_annotations, id_name)
    if ref_id is None:
        return None, []
    return ref_id, [info[0] for info in act_annotations[ref_id]]


def _hms_to_seconds(hms: str) -> int:
    h, m, s = (int(x) for x in hms.split(":"))
    return h * 3600 + m * 60 + s


def action_interval(
    action_entry: Sequence, clip_info: Dict
) -> Tuple[int, int]:
    """One annotation entry ``[action, (start 'HH:MM:SS', _, dur_sec)]`` +
    the clip's info dict -> (start, end) seconds RELATIVE to the clip
    (celev_info.py get_duration: absolute start minus the clip's
    duration.start_sec, clamped at 0, plus the action duration)."""
    start_abs = _hms_to_seconds(action_entry[1][0])
    start = max(int(start_abs - clip_info["duration"]["start_sec"]), 0)
    return start, start + int(action_entry[1][2])


def screen_videos(
    video_names: Iterable[str],
    act_annotations: Dict[str, list],
    clip_annotations: Dict[str, Dict],
    significant_actions: Sequence[str] = SIGNIFICANT_ACTIONS,
    max_per_action: int = 500,
) -> List[Dict]:
    """The celebv_screen_videos.py selection pass.

    For each video: resolve its annotation id, intersect its actions with
    the (shrinking) significant set, and emit one row per matched action
    with the clip-relative interval. An action that reaches
    ``max_per_action`` selections stops accepting new videos — the
    reference mutates its significant list the same way. Videos with no
    annotation or no clip info are skipped (logged loudly), matching its
    try/except-continue."""
    remaining = list(significant_actions)
    counts: Dict[str, int] = {}
    rows: List[Dict] = []
    for name in video_names:
        id_name = strip_video_suffixes(name)
        ref_id, actions = get_actions(act_annotations, id_name)
        if ref_id is None:
            print(f"[celebv] no annotation for {id_name}; skipped")
            continue
        clip_info = clip_annotations.get(ref_id + ".mp4")
        if clip_info is None:
            print(f"[celebv] no clip info for {ref_id}; skipped")
            continue
        # sorted: set-intersection order is hash-seed-randomised per
        # process, which would make quota-boundary selections (and the
        # manifest row order) irreproducible between identical runs
        for action in sorted(set(actions).intersection(remaining)):
            counts[action] = counts.get(action, 0) + 1
            if counts[action] > max_per_action:
                remaining.remove(action)
            entry = next(e for e in act_annotations[ref_id]
                         if e[0] == action)
            try:
                start, end = action_interval(entry, clip_info)
            except (KeyError, ValueError, IndexError) as e:
                print(f"[celebv] bad interval for {ref_id}/{action}: {e!r}")
                continue
            rows.append({"video": name, "id": ref_id, "action": action,
                         "start_sec": start, "end_sec": end})
    return rows


def filter_curated(
    names: Iterable[str], table: Optional[Dict[str, List[str]]] = None
) -> List[Tuple[str, str]]:
    """Keep only ids in the curated action table; returns (name, action)
    pairs (celebv_screen_videos.py delete_irrelevant)."""
    v2a = video_to_action(table)
    out = []
    for name in names:
        action = v2a.get(strip_video_suffixes(name))
        if action is not None:
            out.append((name, action))
    return out
