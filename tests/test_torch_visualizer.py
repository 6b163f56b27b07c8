"""The port's normal-map video path (viz/visualizer.py, viz/pngio.py,
core/projection.py) against the JAX package on the CPU, at 64^2.

Tolerances: float images 1e-5 (the JAX suite's image tolerance); the uint8
frames, cut from those images by truncation, may then differ by 1 where a
value sits on a step of 1/255, in at most 0.1 % of the values."""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.core import projection as jproj
from avi_talking_tpu.viz import pngio as jpng
from avi_talking_tpu.viz import visualizer as jviz
from avi_talking_tpu_torch.core import projection as tproj
from avi_talking_tpu_torch.core.assets import synthetic_assets
from avi_talking_tpu_torch.core.flame import FlameModel
from avi_talking_tpu_torch.viz import pngio as tpng
from avi_talking_tpu_torch.viz import visualizer as tviz
from test_torch_rasterizer import head_proxy_mesh
from _torch_threads import one_torch_thread  # noqa: F401


def tiny_sequence(T=5):
    """Vertices of the tiny config's synthetic FLAME under random
    expressions, and its faces."""
    assets = synthetic_assets(n_shape=8, n_exp=6)
    exp = np.random.default_rng(2).standard_normal((T, 6)).astype(np.float32) * 0.3
    verts = FlameModel(assets, n_shape=8, n_exp=6).vertices_only(
        torch.zeros(T, 8), torch.from_numpy(exp))
    return verts.numpy(), assets.faces.numpy()


def head_sequence(T=3):
    """The closed head mesh (4224 faces: the binned route) moved into model
    space so that the visualizer's camera frames it, nodding a little."""
    hv, faces = head_proxy_mesh()
    frames = []
    for k in range(T):
        v = hv * np.float32(1.0 - 0.05 * k)
        frames.append(np.stack([v[:, 0] / 8, -v[:, 1] / 8 + 0.01, -v[:, 2] / 8], axis=-1))
    return np.asarray(frames, np.float32), faces


def test_batch_orth_proj_matches_jax():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((3, 7, 3)).astype(np.float32)
    cam = rng.standard_normal((3, 3)).astype(np.float32)
    got = tproj.batch_orth_proj(torch.from_numpy(X), torch.from_numpy(cam))
    ref = jproj.batch_orth_proj(jnp.asarray(X), jnp.asarray(cam))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("sequence", [tiny_sequence, head_sequence])
def test_render_verts_matches_jax(sequence):
    verts, faces = sequence()
    viz = tviz.FlameVisualizer(faces, image_size=64, frame_chunk=2, device="cpu")
    got = viz.render_verts(verts)
    ref = jviz.FlameVisualizer(faces, image_size=64, frame_chunk=2).render_verts(jnp.asarray(verts))
    assert got.shape == (verts.shape[0], 64, 64, 3) and got.dtype == np.float32
    assert (got != 0).mean() > 0.05  # the mesh is in frame
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    u8 = (np.clip(got, 0, 1) * 255).astype(np.uint8).astype(int)
    ju8 = (np.clip(ref, 0, 1) * 255).astype(np.uint8).astype(int)
    assert np.abs(u8 - ju8).max() <= 1 and (u8 != ju8).mean() <= 1e-3
    # a tensor input, chunked differently, gives the same frames
    again = tviz.FlameVisualizer(torch.from_numpy(faces), image_size=64, frame_chunk=16,
                                 device="cpu").render_verts(torch.from_numpy(verts))
    np.testing.assert_array_equal(again, got)


def test_write_png_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    for shape in ((5, 7, 3), (4, 6), (3, 3, 4), (2, 9, 2)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        tpng.write_png(str(tmp_path / "t.png"), img)
        jpng.write_png(str(tmp_path / "j.png"), img)
        assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    np.testing.assert_array_equal(jpng.read_png(str(tmp_path / "t.png")), img)


def test_save_frames_as_video_png_fallback_and_ffmpeg(tmp_path, monkeypatch):
    frames = [np.full((8, 8, 3), i * 40, np.uint8) for i in range(3)]
    monkeypatch.setattr(tviz.shutil, "which", lambda name: None)
    out = tviz.save_frames_as_video(frames, str(tmp_path / "a.mp4"))
    assert out == str(tmp_path / "a_frames")
    assert sorted(os.listdir(out)) == ["000000.png", "000001.png", "000002.png"]
    np.testing.assert_array_equal(jpng.read_png(os.path.join(out, "000002.png")), frames[2])
    # with an ffmpeg on the PATH the frames go through it (a stand-in that
    # records its arguments and writes the output file)
    fake = tmp_path / "ffmpeg"
    fake.write_text("#!/bin/sh\nfor a; do last=$a; done\necho \"$@\" > \"$last\"\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(tviz.shutil, "which", lambda name: str(fake))
    wav = tmp_path / "a.wav"
    wav.write_bytes(b"")
    out = tviz.save_frames_as_video(frames, str(tmp_path / "b.mp4"), fps=30, audio_path=str(wav))
    assert out == str(tmp_path / "b.mp4")
    args = (tmp_path / "b.mp4").read_text().split()
    assert args[:3] == ["-y", "-framerate", "30"] and "aac" in args and "yuv420p" in args


def test_visualize_verts_writes_frames(tmp_path, monkeypatch):
    monkeypatch.setattr(tviz.shutil, "which", lambda name: None)
    verts, faces = tiny_sequence(T=3)
    viz = tviz.FlameVisualizer(faces, image_size=32, device="cpu")
    out = viz.visualize_verts(verts, str(tmp_path / "clip.mp4"))
    imgs = viz.render_verts(verts)
    for i in range(3):
        png = jpng.read_png(os.path.join(out, f"{i:06d}.png"))
        np.testing.assert_array_equal(png, (np.clip(imgs[i], 0, 1) * 255).astype(np.uint8))


def test_visualizer_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tviz.FlameVisualizer(np.zeros((1, 3), np.int32))
