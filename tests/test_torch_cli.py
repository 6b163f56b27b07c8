"""The port's command line (``python -m avi_talking_tpu_torch.cli``) on the
CPU at the tiny config: ``generate --save-video``, ``instruct`` and
``serve`` over the fixture corpus in experiments/, each output held to the
port's direct API on the same seeded weights; ``train-emote`` and
``train-prior`` for a few steps, and the flags they refuse."""

import os
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from avi_talking_tpu.viz.pngio import read_png
from avi_talking_tpu_torch.cli import main
from avi_talking_tpu_torch.core.assets import synthetic_assets
from avi_talking_tpu_torch.data import CaptionDataset
from avi_talking_tpu_torch.pipeline import AviTalkingPipeline, PipelineConfig
from avi_talking_tpu_torch.viz import visualizer as tviz
from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CORPUS = ["--json-dir", str(REPO / "experiments" / "json_dir"),
          "--wav-dir", str(REPO / "experiments" / "wav_dir")]


@pytest.fixture(scope="module")
def direct():
    """The pipeline the CLI builds for ``--tiny`` (weights seed 0)."""
    cfg = PipelineConfig.tiny()
    return AviTalkingPipeline.random_init(
        cfg, synthetic_assets(n_shape=cfg.emote.n_shape, n_exp=cfg.emote.n_exp), device="cpu")


def _write_wav(path, seconds, seed):
    rng = np.random.default_rng(seed)
    pcm = (rng.uniform(-0.3, 0.3, int(seconds * 16000)) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


def _assert_npz_matches(path, ref):
    got = np.load(path)
    for key in ("exp", "jaw", "style_emb"):
        np.testing.assert_allclose(got[key], ref[key], atol=1e-6, rtol=0, err_msg=key)


def test_generate_save_video(tmp_path, monkeypatch, direct, capsys):
    monkeypatch.setattr(tviz.shutil, "which", lambda name: None)  # PNG frames, no ffmpeg
    wav = tmp_path / "clip.wav"
    _write_wav(wav, 1.5, seed=0)
    rc = main(["generate", "--wav", str(wav), "--text", "a happy person", "--tiny",
               "--device", "cpu", "--save-video", "--image-size", "64", "--seed", "2",
               "--out", str(tmp_path / "out")])
    assert rc == 0 and "generate:" in capsys.readouterr().out
    ref = direct.generate(str(wav), "a happy person", seed=2)
    _assert_npz_matches(tmp_path / "out" / "clip_coeffs.npz", ref)
    frame_dir = tmp_path / "out" / "clip_frames"
    frames = sorted(os.listdir(frame_dir))
    assert len(frames) == ref["exp"].shape[0] == ref["vertices"].shape[0]
    imgs = tviz.FlameVisualizer(direct.head.flame_assets.faces, 64,
                                device="cpu").render_verts(ref["vertices"][-2:])
    for img, name in zip(imgs, frames[-2:]):
        np.testing.assert_array_equal(read_png(str(frame_dir / name)),
                                      (np.clip(img, 0, 1) * 255).astype(np.uint8))


def test_instruct_over_corpus(tmp_path, direct):
    rc = main(["instruct", *CORPUS, "--tiny", "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    for item in CaptionDataset(*CORPUS[1::2]):
        ref = direct.generate(item.wav_path, item.captions[0], seed=0)
        _assert_npz_matches(tmp_path / f"{item.name}_cap0_coeffs.npz", ref)


def test_serve_over_corpus(tmp_path, capsys):
    rc = main(["serve", *CORPUS, "--tiny", "--device", "cpu", "--max-batch", "4",
               "--max-wait-ms", "30", "--length-buckets", "128", "256", "512",
               "--out", str(tmp_path)])
    assert rc == 0
    assert "served 4 requests" in capsys.readouterr().out
    outs = sorted(tmp_path.glob("*_coeffs.npz"))
    assert len(outs) == 4
    for path in outs:
        z = np.load(path)
        assert z["exp"].shape == (z["jaw"].shape[0], 6) and z["jaw"].shape[1] == 3
        assert all(np.isfinite(z[k]).all() for k in ("exp", "jaw", "style_emb"))


def test_cli_runs_on_the_card_unless_told_otherwise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav = tmp_path / "clip.wav"
    _write_wav(wav, 0.5, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["generate", "--wav", str(wav), "--text", "x", "--tiny", "--out", str(tmp_path)])


@pytest.mark.parametrize("flag", [["--bf16"], ["--checkpoint", "ckpt"]])
def test_unported_flags_exit_with_a_message(tmp_path, flag, monkeypatch, direct):
    """``--bf16`` and ``--checkpoint`` are ported: ``--bf16`` runs the
    pipeline at bfloat16 compute (its coefficients bfloat16 values, within
    bfloat16's reach of the float32 run), and ``--checkpoint`` loads a saved
    pipeline (the output equals the direct API's on those weights), or exits
    with a message when the directory holds no checkpoint."""
    wav = tmp_path / "clip.wav"
    _write_wav(wav, 1.0, seed=3)
    if flag[0] == "--checkpoint":
        with pytest.raises(SystemExit, match="no state.pt"):
            main(["generate", "--wav", str(wav), "--text", "x", "--tiny", "--device", "cpu",
                  "--out", str(tmp_path), "--checkpoint", str(tmp_path / "missing")])
        saved = AviTalkingPipeline.random_init(PipelineConfig.tiny(), seed=4, device="cpu")
        saved.save(str(tmp_path / "ckpt"))
        flag = ["--checkpoint", str(tmp_path / "ckpt")]
        saved.head.flame_assets = direct.head.flame_assets
        ref = saved.generate(str(wav), "x", seed=0)
    else:
        ref = direct.generate(str(wav), "x", seed=0)
    assert main(["generate", "--wav", str(wav), "--text", "x", "--tiny", "--device", "cpu",
                 "--out", str(tmp_path / "out"), *flag]) == 0
    got = np.load(tmp_path / "out" / "clip_coeffs.npz")
    if flag[0] == "--bf16":
        for key in ("exp", "jaw"):
            v = torch.from_numpy(got[key])
            assert torch.equal(v.bfloat16().float(), v), key  # bfloat16 values
            np.testing.assert_allclose(got[key], ref[key], atol=0.1, rtol=0.05, err_msg=key)
    else:
        _assert_npz_matches(tmp_path / "out" / "clip_coeffs.npz", ref)


def test_train_emote_runs_on_cpu(tmp_path, capsys):
    """Two stages of two steps at the tiny config, validation and
    checkpoints in the run directory."""
    run = tmp_path / "run"
    assert main(["train-emote", "--tiny", "--device", "cpu", "--steps", "2", "--batch-size", "2",
                 "--frames", "16", "--val-every", "2", "--run-dir", str(run)]) == 0
    done = [line for line in capsys.readouterr().out.splitlines() if line.startswith("done:")]
    assert len(done) == 1 and done[0].startswith("done: 4 steps, best val ")
    assert np.isfinite(float(done[0].rsplit(" ", 1)[1]))
    for path in ("cfg.json", "checkpoints/best/state.pt", "checkpoints/last/state.pt",
                 "logs/scalars.jsonl"):
        assert (run / path).exists(), path


def test_train_prior_runs_on_cpu(tmp_path, capsys):
    """Four steps with validation every 2, then --resume continues at 4."""
    args = ["train-prior", "--tiny", "--device", "cpu", "--steps", "4", "--batch-size", "8",
            "--val-every", "2", "--ckpt-dir", str(tmp_path / "ck")]
    assert main(args) == 0
    out = capsys.readouterr().out
    final = [line for line in out.splitlines() if line.startswith("final:")]
    assert len(final) == 1 and "'loss_prior'" in final[0] and "best val loss" in out
    assert main(args + ["--resume"]) == 0
    assert "at step 4" in capsys.readouterr().out


@pytest.fixture(scope="module")
def mead_codes_root(tmp_path_factory):
    """Six 20-frame MEAD clips with EMOCA codes and wavs (no crops), as
    ``test_torch_train_data`` writes them."""
    from test_torch_train_data import CLIPS, _write_clip

    root = tmp_path_factory.mktemp("mead_codes")
    rng = np.random.default_rng(0)
    for name in CLIPS:
        _write_clip(root, name, rng)
    return str(root)


@pytest.mark.parametrize("flags", [
    ["--bf16"], ["--neural", "--bf16"], ["--root", "ROOT", "--val-fraction", "0.34", "--bf16"],
], ids=["bf16", "neural-bf16", "root-bf16"])
def test_train_emote_bf16_runs_on_cpu(flags, mead_codes_root, capsys):
    """``train-emote --bf16`` (the head and, with --neural, the towers at
    bfloat16 compute): one step a stage, a finite validation loss."""
    flags = [mead_codes_root if f == "ROOT" else f for f in flags]
    assert main(["train-emote", "--tiny", "--device", "cpu", "--steps", "1", "--batch-size", "2",
                 "--frames", "16", "--val-every", "1", *flags]) == 0
    out = capsys.readouterr().out
    done = [line for line in out.splitlines() if line.startswith("done:")]
    assert len(done) == 1 and done[0].startswith("done: 2 steps, best val ")
    assert np.isfinite(float(done[0].rsplit(" ", 1)[1]))
    assert ("data root: " in out) == ("--root" in flags)


@pytest.mark.parametrize("cmd,flag", [
    # train-prior --dp is ported (tests/test_torch_parallel.py); what is still
    # refused is refused beside the data flags too, before any data is read
    ("train-faceformer", ["--bf16"]),
    ("train-faceformer", ["--checkpoint", "c"]),
    ("train-faceformer", ["--root", "/d", "--bf16"]),
    ("train-faceformer-vert", ["--bf16"]),
    ("train-faceformer-vert", ["--checkpoint", "c"]),
    ("train-faceformer-vert", ["--mead-root", "/d", "--checkpoint", "c"]),
])
def test_training_commands_refuse_what_is_not_ported(cmd, flag):
    with pytest.raises(SystemExit, match=r"not ported to avi_talking_tpu_torch"):
        main([cmd, "--tiny", "--device", "cpu", "--steps", "1", *flag])


@pytest.mark.parametrize("cmd", ["train-emote", "train-prior"])
def test_training_commands_run_on_the_card_unless_told_otherwise(cmd, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([cmd, "--tiny", "--steps", "1"])
