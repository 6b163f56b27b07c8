"""Port parity, the training data: ``build_index`` and its
``index_cache.json`` (one cache both packages read), ``MeadEmocaDataset``
items in the train and val splits (random windows, captions, pose smoothing,
the identity split), ``FaceFormerBatchBuilder``, ``batch_iterator`` over two
epochs, ``CoeffStats`` and ``VocasetDataset``: all bit-equal to the JAX
package's on the same seed and tree."""

import json
import os
import pickle
import wave

import numpy as np
import pytest

from avi_talking_tpu.data import MeadEmocaDataset as JMead
from avi_talking_tpu.data import VocasetDataset as JVoca
from avi_talking_tpu.data import batching as jbatching
from avi_talking_tpu.data import mead as jmead
from avi_talking_tpu.data.splits import mead_identity_split as j_split
from avi_talking_tpu.data.stats import CoeffStats as JStats
from avi_talking_tpu.data.train_batches import FaceFormerBatchBuilder as JBuilder
from avi_talking_tpu_torch.data import MeadEmocaDataset as TMead
from avi_talking_tpu_torch.data import VocasetDataset as TVoca
from avi_talking_tpu_torch.data import batching as tbatching
from avi_talking_tpu_torch.data import mead as tmead
from avi_talking_tpu_torch.data.splits import mead_identity_split as t_split
from avi_talking_tpu_torch.data.stats import CoeffStats as TStats
from avi_talking_tpu_torch.data.train_batches import FaceFormerBatchBuilder as TBuilder
from _torch_threads import one_torch_thread  # noqa: F401

N_FRAMES = 20
CLIPS = [f"{ident}_front_{emo}_level{lvl}_001" for ident in ("M003", "W009")
         for emo, lvl in (("neutral", 1), ("happy", 2), ("angry", 3))]


def _write_wav(path, seconds, sr=16000):
    t = np.linspace(0, seconds, int(sr * seconds), endpoint=False)
    data = (np.sin(2 * np.pi * 220 * t) * 0.3 * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


def _write_clip(root, name, frames, rng, wav=True):
    for i in range(frames):
        fd = root / name / "EMOCA_v2_lr_mse_20" / f"{i:06d}_000"
        fd.mkdir(parents=True)
        np.save(fd / "exp.npy", rng.standard_normal(50).astype(np.float32))
        np.save(fd / "pose.npy", rng.standard_normal(6).astype(np.float32) * 0.1)
        np.save(fd / "shape.npy", rng.standard_normal(100).astype(np.float32))
        np.save(fd / "cam.npy", rng.standard_normal(3).astype(np.float32))
    if wav:
        _write_wav(root / name / f"{os.path.basename(name)}.wav", frames / 25)


@pytest.fixture(scope="module")
def mead_root(tmp_path_factory):
    """Six 20-frame MEAD clips (two identities, three emotions) with EMOCA
    codes and wavs, one 26-frame clip without a wav, an unparseable name,
    a stray file and a nested group."""
    root = tmp_path_factory.mktemp("mead")
    rng = np.random.default_rng(0)
    for name in CLIPS:
        _write_clip(root, name, N_FRAMES, rng)
    _write_clip(root, "W011_front_sad_level1_002", 26, rng, wav=False)
    _write_clip(root, "odd_clip", 12, rng)
    (root / "readme.txt").write_text("not a clip")
    (root / "group").mkdir()
    os.makedirs(root / "group" / "M005_front_fear_level2_003")
    _write_clip(root / "group", "M005_front_fear_level2_003", 18, rng)
    return str(root)


def _same_item(a, b, where=""):
    assert set(a) == set(b), where
    for k in b:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, f"{where} {k}"
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")
        else:
            assert type(a[k]) is type(b[k]) and a[k] == b[k], f"{where} {k}"


def test_build_index_and_cache_match_jax(mead_root, tmp_path):
    ref = jmead.build_index(mead_root, use_cache=False)
    got = tmead.build_index(mead_root, use_cache=False)
    assert got == ref
    # the wav-less, the odd-named and the nested clip are indexed too; the
    # nested one's wav is looked for under <root>/<group>/<clip>/<group>/
    assert len(got) == len(CLIPS) + 3
    assert [c["wav"] is None for c in got].count(True) == 2
    assert not os.path.exists(os.path.join(mead_root, "index_cache.json"))
    # the port writes the cache, and JAX reads it as its own
    assert tmead.build_index(mead_root) == ref
    with open(os.path.join(mead_root, "index_cache.json")) as f:
        assert json.load(f) == ref
    assert jmead.build_index(mead_root) == ref


@pytest.mark.parametrize("split,kw", [
    ("train", {}),
    ("val", {}),
    ("train", {"smooth_pose": True, "seq_length": 25, "seed": 3}),
    ("train", {"subject_split": "train"}),
])
def test_mead_items_match_jax(mead_root, tmp_path, split, kw):
    """Two passes over every item (the window and caption draws of one
    generator), with captions for some clips."""
    caps = tmp_path / "captions.json"
    caps.write_text(json.dumps({CLIPS[0]: ["a", "b", "c"], CLIPS[4]: "one caption"}))
    kw = {"seq_length": 8, **kw}
    j = JMead(root=mead_root, split=split, captions_path=str(caps), **kw)
    t = TMead(root=mead_root, split=split, captions_path=str(caps), **kw)
    assert len(t) == len(j) and len(t) > 0
    np.testing.assert_array_equal(t.stats.mean, j.stats.mean)
    for p in range(2):
        for i in range(len(j)):
            _same_item(t[i], j[i], f"pass {p} item {i}")


def test_identity_split_matches_jax():
    for seed in (None, 4):
        assert t_split(seed=seed) == j_split(seed=seed)
    assert len(t_split()["train"]) == 32


def test_load_images_is_refused(mead_root):
    """Images are ported (``tests/test_torch_train_data.py`` holds them):
    on a tree without crops, ``load_images=True`` items and
    ``FaceFormerBatchBuilder``'s (JAX's default, load_images=True) are
    JAX's, with no ``img``."""
    j, t = JMead(root=mead_root, load_images=True), TMead(root=mead_root, load_images=True)
    for i in range(len(j)):
        _same_item(t[i], j[i], f"item {i}")
        assert "img" not in t[i] and t.image_paths(i) == []
    jb, tb = JBuilder(JMead(root=mead_root), frames=6), TBuilder(TMead(root=mead_root), frames=6)
    for k in range(len(jb)):
        _same_item(tb[k], jb[k], f"builder item {k}")


@pytest.mark.parametrize("frames,coeff_dim", [(6, 9), (32, 53)])  # 32 frames: edge padding
def test_faceformer_batches_over_two_epochs_match_jax(mead_root, frames, coeff_dim):
    jb = JBuilder(JMead(root=mead_root, seq_length=frames), frames=frames, coeff_dim=coeff_dim,
                  load_images=False)
    tb = TBuilder(TMead(root=mead_root, seq_length=frames), frames=frames, coeff_dim=coeff_dim,
                  load_images=False)
    assert len(tb) == len(jb) == len(CLIPS) + 1  # the clips without a wav are left out
    ref = list(jbatching.batch_iterator(jb, 3, seed=1, epochs=2))
    got = list(tbatching.batch_iterator(tb, 3, seed=1, epochs=2))
    assert len(got) == len(ref) == 4
    for n, (g, r) in enumerate(zip(got, ref)):
        _same_item(g, r, f"batch {n}")
    assert set(ref[0]) == {"coeff", "audio", "frame_mask", "emo_idx", "pose", "cam"}
    # MEAD's labels in EMO2IDX order (neutral 0, angry 1, happy 5); -1 for no label
    assert set(np.concatenate([b["emo_idx"] for b in ref]).tolist()) == {-1, 0, 1, 5}


def test_collate_and_unshuffled_batches_match_jax():
    items = [{"a": np.arange(3) + i, "n": i, "x": float(i), "s": f"s{i}",
              "r": np.arange(i + 1)} for i in range(5)]
    for kw in ({"shuffle": False, "drop_last": False}, {"seed": 2, "drop_last": True}):
        ref = list(jbatching.batch_iterator(items, 2, **kw))
        got = list(tbatching.batch_iterator(items, 2, **kw))
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert set(g) == set(r)
            for k in r:
                if isinstance(r[k], np.ndarray):
                    np.testing.assert_array_equal(g[k], r[k])
                else:
                    assert all(np.array_equal(x, y) for x, y in zip(g[k], r[k]))


def test_coeff_stats_match_jax(mead_root, tmp_path):
    ref = JMead(root=mead_root).compute_stats()
    got = TMead(root=mead_root).compute_stats()
    np.testing.assert_array_equal(got.mean, ref.mean)
    np.testing.assert_array_equal(got.std, ref.std)
    x = np.random.default_rng(1).standard_normal((4, 59)).astype(np.float32)
    np.testing.assert_array_equal(got.normalize(x), ref.normalize(x))
    np.testing.assert_array_equal(got.denormalize(x), ref.denormalize(x))
    got.save(str(tmp_path / "m.npy"), str(tmp_path / "s.npy"))
    for pad in (0, 6):
        a = TStats.load(str(tmp_path / "m.npy"), str(tmp_path / "s.npy"), pad_extra=pad)
        b = JStats.load(str(tmp_path / "m.npy"), str(tmp_path / "s.npy"), pad_extra=pad)
        np.testing.assert_array_equal(a.mean, b.mean)
        np.testing.assert_array_equal(a.std, b.std)


@pytest.fixture(scope="module")
def vocaset_root(tmp_path_factory):
    """Two subjects, sentences 1 and 25, 0.5 s wavs, 24 frames of 10
    vertices each (as ``tests/test_data.py`` builds one)."""
    root = tmp_path_factory.mktemp("vocaset")
    (root / "wav").mkdir()
    (root / "vertices_npy").mkdir()
    rng = np.random.default_rng(1)
    templates = {}
    for subj in ["FaceTalk_A", "FaceTalk_B"]:
        templates[subj] = rng.standard_normal((10, 3)).astype(np.float32)
        for sent in [1, 25]:
            name = f"{subj}_sentence{sent:02d}"
            _write_wav(root / "wav" / f"{name}.wav", seconds=0.5)
            np.save(root / "vertices_npy" / f"{name}.npy",
                    rng.standard_normal((24, 30)).astype(np.float32))
    with open(root / "templates.pkl", "wb") as f:
        pickle.dump(templates, f)
    return str(root)


@pytest.mark.parametrize("split,kind", [("train", "vocaset"), ("val", "vocaset"),
                                        ("train", "BIWI")])
def test_vocaset_matches_jax(vocaset_root, split, kind):
    args = (vocaset_root, ["FaceTalk_A"], ["FaceTalk_B"], ["FaceTalk_B"])
    ref = JVoca(*args, split=split, dataset_kind=kind)
    got = TVoca(*args, split=split, dataset_kind=kind)
    assert len(got) == len(ref) > 0
    for g, r in zip(got.items, ref.items):
        _same_item(vars(g), vars(r))
