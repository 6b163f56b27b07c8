"""Port parity, the prior's caption corpus: ``load_corpus_items`` on the
fixture corpus (``experiments/json_dir`` + ``experiments/wav_dir``) and on a
MEAD tree with a captions file or ``TalkClipGenerator``'s captions,
``split_items``, ``tokenize_corpus`` and the batch order of
``prior_corpus_batches`` / ``make_val_batches`` (the latter through
``from_emote_head``), equal to the JAX package's;
``featurize`` within 1e-5 of JAX's on carried tiny CLIP text and style
encoder weights. ``train-prior --json-dir`` / ``--root`` on the CPU print
JAX's corpus and split counts and reach their end."""

import dataclasses
import json
import types
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.data import caption_gen as jgen
from avi_talking_tpu.data import prior_corpus as jpc
from avi_talking_tpu.models.clip_text import ClipTextConfig as JClipCfg
from avi_talking_tpu.models.clip_text import ClipTextModel as JClip
from avi_talking_tpu.models.conditioning import EmotionStyleEncoder as JStyle
from avi_talking_tpu_torch.cli import main
from avi_talking_tpu_torch.data import caption_gen as tgen
from avi_talking_tpu_torch.data import prior_corpus as tpc
from avi_talking_tpu_torch.infra.jax_params import (
    clip_text_state_from_jax,
    style_encoder_state_from_jax,
)
from avi_talking_tpu_torch.models.clip_text import ClipTextConfig, ClipTextModel
from avi_talking_tpu_torch.models.conditioning import EmotionStyleEncoder
from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
JSON_DIR = str(REPO / "experiments" / "json_dir")
WAV_DIR = str(REPO / "experiments" / "wav_dir")
EMOTIONS = ("neutral", "happy", "sad", "surprised", "fear", "disgusted", "angry", "contempt")


@pytest.fixture(scope="module")
def mead(tmp_path_factory):
    """One 2-frame clip per (identity, emotion) for M003 / M005 and the eight
    emotions, an unparseable clip, and a captions file for all but two."""
    tmp = tmp_path_factory.mktemp("prior_corpus")
    root = tmp / "mead"
    names = [f"{ident}_front_{emo}_level{k % 3 + 1}_001"
             for ident in ("M003", "M005") for k, emo in enumerate(EMOTIONS)]
    for name in names + ["odd_clip"]:
        for fr in range(2):
            fd = root / name / "EMOCA_v2_lr_mse_20" / f"{fr:06d}_000"
            fd.mkdir(parents=True)
            for key, n in (("exp", 50), ("pose", 6), ("shape", 100), ("cam", 3)):
                np.save(fd / f"{key}.npy", np.zeros(n, np.float32))
    caps = jgen.TalkClipGenerator(seed=0).build_captions(names[:-2], per_clip=2)
    caps[names[0]] = "one caption"
    cap_path = tmp / "captions.json"
    cap_path.write_text(json.dumps(caps))
    return str(root), str(cap_path), names


def _rows(items):
    return [dataclasses.astuple(it) for it in items]


@pytest.mark.parametrize("layout", ["json_wav", "json", "mead_captions", "mead_generated",
                                    "both"])
def test_corpus_items_match_jax(mead, layout):
    root, cap_path, names = mead
    kw = {"json_wav": dict(json_dir=JSON_DIR, wav_dir=WAV_DIR), "json": dict(json_dir=JSON_DIR),
          "mead_captions": dict(mead_root=root, captions_path=cap_path),
          "mead_generated": dict(mead_root=root),
          "both": dict(json_dir=JSON_DIR, wav_dir=WAV_DIR, mead_root=root,
                       captions_path=cap_path)}[layout]
    got, ref = tpc.load_corpus_items(**kw), jpc.load_corpus_items(**kw)
    assert _rows(got) == _rows(ref) and len(ref) > 0
    if layout == "json_wav":  # M012_front_neutral_level1_017: identity 5, neutral, level 1
        assert len(got) == 4 and {r[2:] for r in _rows(got)} == {(5, 0, 0)}
    if layout == "mead_captions":  # two captions a clip; one for the first; none for the last two
        assert len(got) == 2 * (len(names) - 2) - 1


def test_caption_generator_matches_jax(mead):
    names = mead[2] + ["W009_front_fear_level3_017.wav", "bad"]
    for kw in ({}, {"seed": 3, "max_aus": 2}):
        t, j = tgen.TalkClipGenerator(**kw), jgen.TalkClipGenerator(**kw)
        assert [t.query(n) for n in names] == [j.query(n) for n in names]
        assert t.build_captions(names, per_clip=2) == j.build_captions(names, per_clip=2)


@pytest.mark.parametrize("val_fraction", [0.0, 0.1, 0.25, 0.5])
@pytest.mark.parametrize("seed", [0, 2])
def test_split_items_matches_jax(mead, val_fraction, seed):
    items = jpc.load_corpus_items(json_dir=JSON_DIR, wav_dir=WAV_DIR, mead_root=mead[0],
                                  captions_path=mead[1])
    got = tpc.split_items([tpc.PriorCorpusItem(*r) for r in _rows(items)], val_fraction, seed)
    ref = jpc.split_items(items, val_fraction, seed)
    assert [_rows(s) for s in got] == [_rows(s) for s in ref]
    with pytest.raises(ValueError):
        tpc.split_items(got[0], 1.0)


def _tokenizer(vocab_size=99, max_length=16):
    def tok(texts):
        out = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            for k, w in enumerate(t.lower().split()[:max_length]):
                out[i, k] = zlib.crc32(w.encode()) % vocab_size
        return out

    return tok


@pytest.fixture(scope="module")
def featurizers():
    """JAX's featurizer on a tiny CLIP (24 wide, one layer, 16 tokens) and a
    16-d style encoder over 9 + 3 + 32 + 8 conditions, and the port's on
    the same weights."""
    cfg = dict(vocab_size=99, hidden_size=24, num_layers=1, num_heads=2, intermediate_size=32,
               max_position_embeddings=16)
    jclip, jstyle = JClip(JClipCfg(**cfg)), JStyle(16)
    rng = jax.random.PRNGKey(0)
    clip_p = jax.jit(jclip.init)(rng, jnp.zeros((1, 16), jnp.int32))
    style_p = jax.jit(jstyle.init)(rng, jnp.zeros((1, 52)))
    jf = jpc.PriorCorpusFeaturizer(clip_model=jclip, clip_params=clip_p, style_encoder=jstyle,
                                   style_params=style_p, tokenizer=_tokenizer(), shape_dim=8)
    clip = ClipTextModel(ClipTextConfig(**cfg)).eval()
    clip.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in clip_text_state_from_jax(
        jax.tree.map(np.asarray, clip_p["params"])).items()})
    style = EmotionStyleEncoder(52, 16)
    style.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in
                           style_encoder_state_from_jax(style_p["params"]).items()})
    tf = tpc.PriorCorpusFeaturizer(clip_model=clip, style_encoder=style, tokenizer=_tokenizer(),
                                   shape_dim=8)
    return jf, tf


def _close(got: dict, ref: dict, where: str):
    for k in ("voxel", "style_target"):
        r = np.asarray(ref[k])
        assert got[k].shape == r.shape, (where, k)
        assert float(np.abs(got[k].numpy() - r).max()) <= 1e-5 * max(1.0, np.abs(r).max()), (
            where, k)


def test_featurized_batches_match_jax(mead, featurizers):
    """The tokenized corpus bit-equal, then the featurized batches (a batch
    wider than an epoch's rest, so the order wraps into the next
    permutation) and the fixed validation batches within 1e-5."""
    jf, tf = featurizers
    items = jpc.load_corpus_items(mead_root=mead[0], captions_path=mead[1])
    titems = [tpc.PriorCorpusItem(*r) for r in _rows(items)]
    got, ref = tf.tokenize_corpus(titems), jf.tokenize_corpus(items)
    for k in ("ids", "cond"):
        np.testing.assert_array_equal(got[k], ref[k])
    ref_b = list(jpc.prior_corpus_batches(items, jf, 12, 4, seed=1))
    got_b = list(tpc.prior_corpus_batches(titems, tf, 12, 4, seed=1))
    assert len(got_b) == len(ref_b) == 4
    for n, (g, r) in enumerate(zip(got_b, ref_b)):
        _close(g, r, f"batch {n}")
    # the style tower taken from an EMOTE head, as from_emote_head takes it
    head_tf = tpc.PriorCorpusFeaturizer.from_emote_head(
        tf.clip_model, types.SimpleNamespace(style_encoder=tf.style_encoder), tf.tokenizer,
        shape_dim=8)
    ref_v, got_v = list(jpc.make_val_batches(items, jf, 12, 2)()), list(
        tpc.make_val_batches(titems, head_tf, 12, 2)())
    assert len(got_v) == len(ref_v) == 2
    for n, (g, r) in enumerate(zip(got_v, ref_v)):
        _close(g, r, f"val batch {n}")
    with pytest.raises(ValueError, match="empty corpus"):
        tf.tokenize_corpus([])
    with pytest.raises(ValueError, match="out of range"):
        tf.tokenize_corpus([tpc.PriorCorpusItem("x", "a", 0, 9, 0)])


def test_cli_train_prior_json_dir_prints_jax_counts(capsys, tmp_path):
    items = jpc.load_corpus_items(json_dir=JSON_DIR, wav_dir=WAV_DIR)
    tr, va = jpc.split_items(items, 0.25)
    assert main(["train-prior", "--tiny", "--device", "cpu", "--steps", "2", "--batch-size", "4",
                 "--val-every", "2", "--val-steps", "1", "--json-dir", JSON_DIR, "--wav-dir",
                 WAV_DIR, "--val-fraction", "0.25", "--ckpt-dir", str(tmp_path / "ck")]) == 0
    out, err = capsys.readouterr()
    assert f"corpus: {len(items)} caption pairs" in out
    assert f"split: {len(tr)} train / {len(va)} val" in out
    assert "val@2" in out and "best val loss" in out and (tmp_path / "ck" / "best").is_dir()
    assert err.count("RANDOM-init") == 2


def test_cli_train_prior_mead_root(mead, capsys):
    root = mead[0]
    items = jpc.load_corpus_items(mead_root=root)
    assert main(["train-prior", "--tiny", "--device", "cpu", "--steps", "1", "--batch-size", "8",
                 "--root", root]) == 0
    out = capsys.readouterr().out
    assert f"corpus: {len(items)} caption pairs" in out
    assert f"split: {len(items)} train / 0 val" in out and "final:" in out


def test_cli_train_prior_corpus_refusals(tmp_path, mead):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no \\(caption, condition\\) pairs"):
        main(["train-prior", "--tiny", "--device", "cpu", "--steps", "1", "--json-dir", str(empty)])
    one = tmp_path / "one.json"  # every caption of one clip: nothing for validation
    one.write_text(json.dumps({mead[2][1]: ["a", "b"]}))
    with pytest.raises(SystemExit, match="val split is empty"):
        main(["train-prior", "--tiny", "--device", "cpu", "--steps", "1", "--val-every", "1",
              "--root", mead[0], "--captions", str(one)])
