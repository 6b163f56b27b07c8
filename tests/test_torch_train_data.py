"""Port parity, the data-backed training batches and conditioning:
``MeadEmocaDataset(load_images=True)``'s ``img`` / ``ref_img`` (the neutral
clip's crops, or the clip's own where the identity has none) and the crop
layouts; ``EmoteBatchBuilder``'s items, ``split`` and ``emote_batches``'
order; ``ScreenedMeadAudio``; all bit-equal to the JAX package's on the
same tree. ``mask_lip`` in both variants, bit-equal. ``FanConditioner``
on a reference-named FAN state dict: the draws equal, the embeddings within
1e-4 of their largest value (the FAN's tolerance in
``test_torch_fan_emo_cls.py``), through the command's own source and
conditioning (``cli.train.mead_source`` with ``--fan-checkpoint``) against
JAX's builder and conditioner. The ``--root`` commands on the CPU."""

import types
import wave

import jax
import numpy as np
import pytest
import torch

from avi_talking_tpu.data import MeadEmocaDataset as JMead
from avi_talking_tpu.data import batching as jbatching
from avi_talking_tpu.data import mead as jmead
from avi_talking_tpu.data import train_batches as jtb
from avi_talking_tpu.models.fan_encoder import FanEncoder as JFan
from avi_talking_tpu.models.fan_encoder import fan_encoder_params_from_torch
from avi_talking_tpu.models.fan_encoder import mask_lip as j_mask_lip
from avi_talking_tpu_torch.cli import main
from avi_talking_tpu_torch.cli.train import conditioned as conditioned_batch
from avi_talking_tpu_torch.cli.train import frozen_fan, mead_source
from avi_talking_tpu_torch.data import MeadEmocaDataset as TMead
from avi_talking_tpu_torch.data import mead as tmead
from avi_talking_tpu_torch.data import train_batches as ttb
from avi_talking_tpu_torch.models.faceformer import FaceFormerConfig
from avi_talking_tpu_torch.models.fan_encoder import FanEncoder
from avi_talking_tpu_torch.models.fan_encoder import mask_lip as t_mask_lip
from avi_talking_tpu_torch.viz.pngio import write_png
from _torch_threads import one_torch_thread  # noqa: F401

N_FRAMES = 20
IMG = 64
CLIPS = [f"{ident}_front_{emo}_level{lvl}_001" for ident in ("M003", "W009")
         for emo, lvl in (("neutral", 1), ("happy", 2), ("angry", 3))]
LONE = "W011_front_sad_level1_001"  # no neutral clip; crops beside its frames directory


def _write_wav(path, seconds, sr=16000):
    t = np.linspace(0, seconds, int(sr * seconds), endpoint=False)
    data = (np.sin(2 * np.pi * 220 * t) * 0.3 * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


def _write_clip(root, name, rng, det=None):
    frames = root / name / "EMOCA_v2_lr_mse_20"
    for i in range(N_FRAMES):
        fd = frames / f"{i:06d}_000"
        fd.mkdir(parents=True)
        np.save(fd / "exp.npy", rng.standard_normal(50).astype(np.float32))
        np.save(fd / "pose.npy", rng.standard_normal(6).astype(np.float32) * 0.1)
        np.save(fd / "shape.npy", rng.standard_normal(100).astype(np.float32))
        np.save(fd / "cam.npy", rng.standard_normal(3).astype(np.float32))
    _write_wav(root / name / f"{name}.wav", seconds=N_FRAMES / 25)
    if det is None:
        return
    det = root / name / det
    det.mkdir(parents=True)
    for i in range(N_FRAMES):
        write_png(str(det / f"{i:06d}_000.png"),
                  rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def mead_root(tmp_path_factory):
    """Six 20-frame clips (two identities x neutral / happy / angry) with
    EMOCA codes, wavs and 64^2 crops under ``processed_x/detections``, as
    ``tests/test_train_batches.py`` builds them, and a seventh clip of a
    third identity without a neutral clip, its crops in ``detections``."""
    root = tmp_path_factory.mktemp("mead_images")
    rng = np.random.default_rng(0)
    for name in CLIPS:
        _write_clip(root, name, rng, "EMOCA_v2_lr_mse_20/processed_x/detections")
    _write_clip(root, LONE, rng, "detections")
    return str(root)


def _same(a, b, where=""):
    assert set(a) == set(b), where
    for k in b:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, f"{where} {k}"
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")
        else:
            assert type(a[k]) is type(b[k]) and a[k] == b[k], f"{where} {k}"


@pytest.mark.parametrize("split,seq_length", [("train", 8), ("val", 8), ("train", 32)])
def test_mead_images_match_jax(mead_root, split, seq_length):
    """Two passes over every item: windows, crops and the neutral reference
    (the lone identity's is its own), at 8 frames and at 32 (the whole clip)."""
    kw = dict(root=mead_root, split=split, seq_length=seq_length, load_images=True)
    j, t = JMead(**kw), TMead(**kw)
    assert len(t) == len(j) == 7
    for p in range(2):
        for i in range(len(j)):
            got, ref = t[i], j[i]
            _same(got, ref, f"pass {p} item {i}")
            L = min(seq_length, N_FRAMES)  # the dataset does not pad; the builders do
            assert got["img"].shape == got["ref_img"].shape == (L, IMG, IMG, 3)
            if ref["name"] == LONE:
                own = t._load_image_window(t.index[i], 0, L)
                np.testing.assert_array_equal(got["ref_img"], own)
    for i in range(len(j)):
        assert t.image_paths(i) == j.image_paths(i) and len(t.image_paths(i)) == N_FRAMES


@pytest.mark.parametrize("layout", ["frames/*/detections", "frames/*/*/detections",
                                    "clip/*/detections", "clip/detections", "none"])
def test_crop_layouts_match_jax(tmp_path, layout):
    frames = tmp_path / "clip" / "EMOCA_v2_lr_mse_20"
    (frames / "000000_000").mkdir(parents=True)
    base, _, rest = layout.partition("/")
    det = {"frames": frames, "clip": tmp_path / "clip"}.get(base)
    if det is not None:
        det = det / rest.replace("*", "processed_a")
        det.mkdir(parents=True)
        for i in (1, 0, 2):
            (det / f"{i:06d}_000.png").write_bytes(b"")
    clip = {"frames": [str(frames / "000000_000")]}
    got = tmead.MeadEmocaDataset._clip_image_paths(clip)
    assert got == jmead.MeadEmocaDataset._clip_image_paths(clip)
    assert len(got) == (0 if det is None else 3) and got == sorted(got)


@pytest.mark.parametrize("val_fraction", [0.0, 0.34, 0.5])
def test_emote_builder_split_and_batches_match_jax(mead_root, val_fraction):
    """Items of both sides, and the batch order over two training epochs
    and one unshuffled validation epoch."""
    sides = []
    for mead, tb in ((JMead, jtb), (TMead, ttb)):
        b = tb.EmoteBatchBuilder(mead(root=mead_root, seq_length=8), frames=8, n_exp=6, n_shape=8)
        tr, va = b.split(val_fraction, seed=1)
        sides.append((b, tr, va, list(tb.emote_batches(tr, 2, seed=3, epochs=2)),
                      list(tb.emote_batches(va, 2, shuffle=False, epochs=1))))
    (jb, jtr, jva, jbat, jval), (tb_, ttr, tva, tbat, tval) = sides
    assert tb_.valid == jb.valid and len(tb_) == 7
    assert (ttr.valid, tva.valid) == (jtr.valid, jva.valid)
    assert tva.ds.split == "val" and ttr.ds.split == "train"
    assert len(tbat) == len(jbat) > 0 and len(tval) == len(jval)
    for n, (g, r) in enumerate(zip(tbat + tval, jbat + jval)):
        _same(g, r, f"batch {n}")


def test_emote_items_pad_and_fit_as_jax(mead_root):
    """32-frame windows of 20-frame clips (padding), n_exp 60 > 50 and
    n_shape 300 > 100 (zero-filled widths)."""
    j = jtb.EmoteBatchBuilder(JMead(root=mead_root, seq_length=32, split="val"), frames=32,
                              n_exp=60, n_shape=300)
    t = ttb.EmoteBatchBuilder(TMead(root=mead_root, seq_length=32, split="val"), frames=32,
                              n_exp=60, n_shape=300)
    for k in range(len(j)):
        _same(t[k], j[k], f"item {k}")
    assert t[0]["frame_mask"].sum() == N_FRAMES


@pytest.mark.parametrize("allow", [None, 3])
def test_screened_mead_audio_matches_jax(mead_root, tmp_path, allow):
    path = None
    if allow is not None:
        wavs = sorted(c["wav"] for c in tmead.build_index(mead_root))
        path = tmp_path / "meta_audio.txt"
        path.write_text("\n".join(wavs[:allow]) + "\n")
    kw = dict(roots=[mead_root], allowlist_path=None if path is None else str(path))
    got, ref = tmead.ScreenedMeadAudio(**kw), jmead.ScreenedMeadAudio(**kw)
    assert len(got) == len(ref) == (7 if allow is None else allow)
    assert (got.wav_paths, got.names, got.captions) == (ref.wav_paths, ref.names, ref.captions)


@pytest.mark.parametrize("variant", ["coeff", "disentangle"])
@pytest.mark.parametrize("hw", [(64, 64), (224, 224), (97, 50)])
def test_mask_lip_matches_jax(variant, hw):
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = np.asarray(j_mask_lip(x, variant))
    got = t_mask_lip(torch.from_numpy(x).permute(0, 3, 1, 2), variant).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref)


def _reference_fan_state(seed=3):
    """A FAN state dict under the reference names (random weights, BatchNorm
    statistics away from 0 / 1)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in FanEncoder(IMG).state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.long)
        elif k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
    return sd


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def conditioned(mead_root, tmp_path_factory):
    """JAX's conditioned batch: the first batch of JAX's FaceFormer builder
    (B=2, T=6, crops) through JAX's FanConditioner (seed 0) on a FAN carried
    from a reference-named state dict, which is also saved for
    ``--fan-checkpoint``."""
    sd = _reference_fan_state()
    ckpt = tmp_path_factory.mktemp("fan") / "fan.pt"
    torch.save({"state_dict": sd}, ckpt)
    cond = jtb.FanConditioner(JFan(), jax.tree.map(np.asarray, fan_encoder_params_from_torch(sd)),
                              seed=0)
    builder = jtb.FaceFormerBatchBuilder(JMead(root=mead_root, seq_length=6), frames=6,
                                         coeff_dim=9, load_images=True)
    b = next(jbatching.batch_iterator(builder, 2, epochs=None))
    out = {k: np.asarray(v) for k, v in cond.condition(b["img"], b["coeff"]).items()}
    return str(ckpt), b, out, cond._rng.bit_generator.state


def test_fan_conditioner_matches_jax(mead_root, conditioned):
    """``train-faceformer --root --fan-checkpoint``'s source and
    conditioning (``cli.train.mead_source`` / ``conditioned``): the batch
    bit-equal to JAX's ``FaceFormerBatchBuilder``'s, the FanConditioner's
    draws equal (its generator ends in the same state), ``ref_coeff`` equal,
    the eye and emotion embeddings within 1e-4 of their largest."""
    ckpt, ref_b, ref, state = conditioned
    cfg = FaceFormerConfig.tiny()
    args = types.SimpleNamespace(root=mead_root, seq_length=6, batch_size=2, seed=0,
                                 fan_checkpoint=ckpt)
    source, cond = mead_source(args, cfg, torch.device("cpu"))
    b = next(source)
    _same({k: b[k] for k in ref_b}, ref_b)
    out = conditioned_batch(b, cfg, cond, torch.device("cpu"))
    assert cond._rng.bit_generator.state == state, "the draws differ"
    assert {k: tuple(v.shape) for k, v in out.items()} == {
        "audio": (2, 6 * 640), "coeff": (2, 6, 9), "eye_embed": (2, 6, 6), "emo_embed": (2, 6, 30),
        "ref_coeff": (2, 1, 9)}
    np.testing.assert_array_equal(out["ref_coeff"].numpy(), ref["ref_coeff"])
    for k in ("eye_embed", "emo_embed"):
        assert _rel(out[k], ref[k]) < 1e-4, k
    # the offsets: U[4, 8), wrapped
    idx = ttb.FanConditioner(cond.fan, seed=1).shuffle_indices(20)
    np.testing.assert_array_equal(idx, jtb.FanConditioner(JFan(), {}, seed=1).shuffle_indices(20))
    assert ((np.abs(idx - np.arange(20)) >= 4) & (np.abs(idx - np.arange(20)) <= 7)).all()


def test_cli_train_emote_root_prints_jax_split(mead_root, capsys):
    b = jtb.EmoteBatchBuilder(JMead(root=mead_root, seq_length=8), frames=8, n_exp=6, n_shape=8)
    jtr, jva = b.split(0.34)
    assert main(["train-emote", "--tiny", "--root", mead_root, "--device", "cpu", "--steps", "1",
                 "--batch-size", "2", "--frames", "8", "--val-every", "1", "--val-fraction",
                 "0.34"]) == 0
    out = capsys.readouterr().out
    assert f"data root: {len(jtr)} train / {len(jva)} val clips" in out
    done = [line for line in out.splitlines() if line.startswith("done:")]
    assert len(done) == 1 and done[0].startswith("done: 2 steps, best val ")
    assert np.isfinite(float(done[0].rsplit(" ", 1)[1]))


def test_cli_train_faceformer_root_runs(mead_root, conditioned, capsys):
    """One step on one 4-frame clip a batch (the conditioning's FAN passes
    are most of the cost) with ``--fan-checkpoint``; without it the tower
    is seeded and says so."""
    assert main(["train-faceformer", "--tiny", "--root", mead_root, "--device", "cpu", "--steps",
                 "1", "--batch-size", "1", "--seq-length", "4",
                 "--fan-checkpoint", conditioned[0]]) == 0
    out, err = capsys.readouterr()
    final = [line for line in out.splitlines() if line.startswith("final:")]
    assert len(final) == 1 and np.isfinite(float(final[0].split("'loss': ")[1].rstrip("}")))
    assert "RANDOM-init" not in err
    frozen_fan(types.SimpleNamespace(fan_checkpoint=None), IMG, torch.device("cpu"))
    assert "RANDOM-init" in capsys.readouterr().err


def test_cli_root_refusals(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    for cmd in (["train-emote", "--frames", "8"], ["train-faceformer"]):
        with pytest.raises(SystemExit, match="no usable MEAD clips"):
            main([*cmd, "--tiny", "--root", str(empty), "--device", "cpu", "--steps", "1"])
    bare = tmp_path / "bare"  # one clip with codes and a wav, no crops
    _write_clip(bare, CLIPS[0], np.random.default_rng(1))
    with pytest.raises(SystemExit, match="detection crops"):
        main(["train-faceformer", "--tiny", "--root", str(bare), "--device", "cpu", "--steps", "1",
              "--batch-size", "2", "--seq-length", "6"])
