"""Port parity of the host-only data commands: ``screen-videos`` (CelebV-Text
screening, ``data.celebv``, and ``--curated`` on the packaged action
table) and ``translate-captions`` (``data.caption_translate``), each
command's output equal to the JAX command's on the same inputs; and the
port's rule that they, like every entry point, want the card unless
``--device cpu`` is given."""

import dataclasses
import json
import os
import pickle

import pytest
import torch

from avi_talking_tpu import cli as jcli
from avi_talking_tpu.data import caption_translate as jct
from avi_talking_tpu.data import celebv as jcv
from avi_talking_tpu_torch import cli as tcli
from avi_talking_tpu_torch.data import caption_translate as tct
from avi_talking_tpu_torch.data import celebv as tcv
from _torch_threads import one_torch_thread  # noqa: F401

STYLE_B = [
    "The anger is inferred from the lowered brow, raised cheek and the tightening of the lips.",
    "She looks extremely happy, smiling with her lip corners pulled and cheeks raised.",
    "A slightly sad man with the inner brow raised and lip corner depressed.",
    "He appears calm and relaxed.",
    "Shock shows in the dropped jaw, the raised upper lid and separated lips, fairly clearly.",
    "Disgust: the nose wrinkles and the upper lip is raised.",
]


def _run_both(argv, tmp_path, out_name):
    """The port's command (on the CPU) and JAX's with the same arguments,
    each writing its own ``--out``: (rc, output) pairs."""
    res = []
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        out = str(tmp_path / f"{name}_{out_name}")
        rc = main([*argv, "--out", out, *extra])
        with open(out) as f:
            res.append((rc, json.load(f)))
    return res


def _celebv_inputs(tmp_path):
    """A video folder (names with the download tool's dash and suffix
    artefacts, curated ids among them), CelebV-style annotations as a
    pickle and a JSON, and the clip info."""
    table = tcv.load_action_table()
    curated = [table["nod"][0], table["turn"][3], table["shake_head"][7]]
    ids = curated + ["abc_1_0", "-def_2_0", "ghi_3_0", "nope_9_9"]
    vids = tmp_path / "videos"
    vids.mkdir()
    for i, name in enumerate(ids):
        (vids / (name.lstrip("-") + (".mp4.mp4" if i == 4 else ".mp4"))).write_bytes(b"x")
    acts = ["smile", "nod", "blink", "sneeze", "laugh", "turn", "frown"]
    act = {}
    for i, vid in enumerate(ids[:-1]):
        act[vid] = [[acts[(i + k) % len(acts)], ["00:00:%02d" % (3 + 2 * k), "x", 2 + k]]
                    for k in range(3)]
    clip_info = {vid + ".mp4": {"duration": {"start_sec": 2 + (i % 3)}}
                 for i, vid in enumerate(ids[:-2])}
    with open(tmp_path / "ann.pkl", "wb") as f:
        pickle.dump({"act": act}, f)
    with open(tmp_path / "ann.json", "w") as f:
        json.dump({"act": act}, f)
    with open(tmp_path / "info.json", "w") as f:
        json.dump(clip_info, f)
    return vids


@pytest.mark.parametrize("mode", ["pickle", "json_quota", "curated"])
def test_screen_videos_matches_jax(tmp_path, mode):
    vids = _celebv_inputs(tmp_path)
    if mode == "curated":
        argv = ["screen-videos", "--src", str(vids), "--curated"]
    else:
        ann = "ann.pkl" if mode == "pickle" else "ann.json"
        argv = ["screen-videos", "--src", str(vids), "--annotations", str(tmp_path / ann),
                "--clip-info", str(tmp_path / "info.json")]
        if mode == "json_quota":
            argv += ["--max-per-action", "1", "--actions", "smile,nod,laugh,frown"]
    (rc, got), (jrc, want) = _run_both(argv, tmp_path, "sel.json")
    assert rc == jrc == 0
    assert got == want and len(got) >= 3


def test_celebv_library_matches_jax():
    assert tcv.SIGNIFICANT_ACTIONS == jcv.SIGNIFICANT_ACTIONS
    assert tcv.load_action_table() == jcv.load_action_table()
    assert tcv.video_to_action() == jcv.video_to_action()
    for name in ("x.mp4.mp4", "/a/b/y_1_0.pkl", "z.avi.json", "plain"):
        assert tcv.strip_video_suffixes(name) == jcv.strip_video_suffixes(name)
    entry, info = ["nod", ["00:01:05", "x", 4]], {"duration": {"start_sec": 60}}
    assert tcv.action_interval(entry, info) == jcv.action_interval(entry, info) == (5, 9)


@pytest.mark.parametrize("fmt", ["txt", "json", "prompt"])
def test_translate_captions_matches_jax(tmp_path, fmt, capsys):
    src = tmp_path / ("caps.json" if fmt == "json" else "caps.txt")
    if fmt == "json":
        src.write_text(json.dumps({"captions": STYLE_B}))
    else:
        src.write_text("\n".join(STYLE_B) + "\n\n")
    if fmt == "prompt":
        assert tcli.main(["translate-captions", "--input", str(src), "--emit-prompt",
                          "--device", "cpu"]) == 0
        got = capsys.readouterr().out
        assert jcli.main(["translate-captions", "--input", str(src), "--emit-prompt"]) == 0
        assert got == capsys.readouterr().out and "Style B sentences" in got
        return
    (rc, got), (jrc, want) = _run_both(["translate-captions", "--input", str(src), "--seed", "3"],
                                       tmp_path, "a.json")
    assert rc == jrc == 0 and got == want and len(got) == len(STYLE_B)


def test_caption_translate_library_matches_jax():
    for s in STYLE_B:
        assert dataclasses.astuple(tct.parse_style_b(s)) == dataclasses.astuple(jct.parse_style_b(s))
        for seed in (0, 7):
            assert tct.translate_style_b_to_a(s, seed) == jct.translate_style_b_to_a(s, seed)
    assert tct.translate_corpus(STYLE_B, 2) == jct.translate_corpus(STYLE_B, 2)
    assert tct.build_translation_prompt(STYLE_B[:2]) == jct.build_translation_prompt(STYLE_B[:2])


@pytest.mark.parametrize("argv", [["screen-videos", "--src", "x", "--out", "y", "--curated"],
                                  ["translate-captions", "--input", "x"]])
def test_host_commands_want_the_card_without_device(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)
    assert not os.path.exists("y")
