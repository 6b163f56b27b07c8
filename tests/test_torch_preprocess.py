"""Port parity of the preprocessing path: ``data.yuv``, ``data.batching.
chunked_apply``, ``data.facecrop`` (``warp_crop`` in float and uint8, the
full-frame landmark detection with and without the S3FD box stage,
``smooth_track``), ``data.preprocess`` (``EmocaPreprocessor`` under each
transport, ``pseudo_gt``, ``landmarks_from_codes``) and the
``preprocess-mead`` command, file by file against JAX's
``preprocess_clip_folder`` / ``preprocess_clip_video`` on the same weights
(the port's seeded nets through JAX's reference importers), ``--videos``
through a stub ffmpeg.

Crops and masks are held exactly except where a value sits on a rounding
or argmax near-tie; those are counted and printed."""

import glob
import os
import wave

import jax
import numpy as np
import pytest
import torch

from avi_talking_tpu.core import FlameModel as JFlame
from avi_talking_tpu.core import synthetic_assets as jsynthetic
from avi_talking_tpu.data import facecrop as jfc
from avi_talking_tpu.data import preprocess as jpre
from avi_talking_tpu.data import yuv as jyuv
from avi_talking_tpu.models import bisenet as jbis
from avi_talking_tpu.models import emoca as jemoca
from avi_talking_tpu.models import fan_landmarks as jfan
from avi_talking_tpu.models import sfd as jsfd
from avi_talking_tpu_torch.cli import main
from avi_talking_tpu_torch.core.assets import synthetic_assets
from avi_talking_tpu_torch.core.flame import FlameModel
from avi_talking_tpu_torch.data import facecrop as tfc
from avi_talking_tpu_torch.data import preprocess as tpre
from avi_talking_tpu_torch.data import yuv as tyuv
from avi_talking_tpu_torch.data.batching import chunked_apply
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.models.bisenet import BiSeNet
from avi_talking_tpu_torch.models.emoca import EmocaEncoder
from avi_talking_tpu_torch.models.fan_landmarks import FanLandmarkDetector, FanLandmarkNet
from avi_talking_tpu_torch.models.sfd import S3FD, SfdDetector
from avi_talking_tpu_torch.viz.pngio import read_png, write_png
from _torch_threads import one_torch_thread  # noqa: F401
from test_videoio import _install_stubs, _make_video, _packed

CPU = torch.device("cpu")
TINY_FAN = dict(num_modules=1, depth=2, stem_features=8, features=16)


def _seeded(factory, seed):
    return random_module(factory, CPU, torch.Generator().manual_seed(seed))


def _np_state(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.fixture(scope="module")
def nets():
    """The command's nets at --tiny, seeded as the command seeds them
    (encoder 0, FAN 1, BiSeNet 2), and JAX's twins on the same weights."""
    enc = _seeded(lambda: EmocaEncoder(n_exp=6), 0)
    fan = _seeded(lambda: FanLandmarkNet(**TINY_FAN), 1)
    bis = _seeded(BiSeNet, 2)
    sfd = _seeded(S3FD, 3)
    jenc = jemoca.EmocaEncoder(n_exp=6)
    jfan_net = jfan.FanLandmarkNet(num_modules=1, depth=2, stem_features=8, features=16)
    return dict(
        enc=enc, fan=fan, bis=bis, sfd=sfd, jenc=jenc,
        jenc_vars=jemoca.emoca_encoder_params_from_torch(_np_state(enc)),
        jfan=jfan_net,
        jfan_vars=jfan.fan_landmarks_params_from_torch(_np_state(fan), num_modules=1, depth=2),
        jbis_vars=jbis.bisenet_params_from_torch(_np_state(bis)),
        jsfd_vars=jsfd.sfd_params_from_torch(_np_state(sfd)))


def _face_frames(n, h, w, seed):
    """Face-like frames: a bright ellipse with two dark eyes on noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        cx, cy = w * (0.5 + 0.03 * np.sin(i)), h * (0.5 + 0.02 * np.cos(i))
        img = rng.uniform(0, 0.4, (h, w, 3)).astype(np.float32)
        face = ((xx - cx) / (0.22 * w)) ** 2 + ((yy - cy) / (0.3 * h)) ** 2 < 1
        img[face] = [0.85, 0.65, 0.55]
        for ex in (-0.08, 0.08):
            eye = ((xx - cx - ex * w) ** 2 + (yy - cy + 0.06 * h) ** 2) < (0.03 * w) ** 2
            img[eye] = 0.1
        out.append((img * 255).astype(np.uint8))
    return np.stack(out)


# --------------------------------------------------------------- yuv, chunks --


def test_yuv420_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (3, 8, 12, 3), dtype=np.uint8)
    packed = tyuv.rgb_to_yuv420(frames)
    np.testing.assert_array_equal(packed, jyuv.rgb_to_yuv420(frames))
    assert packed.shape == (3, tyuv.yuv420_packed_size(8, 12))
    host = tyuv.yuv420_to_rgb_host(packed, 8, 12)
    np.testing.assert_array_equal(host, jyuv.yuv420_to_rgb_host(packed, 8, 12))
    dev = tyuv.yuv420_to_rgb(torch.from_numpy(packed), 8, 12).numpy()
    np.testing.assert_allclose(dev, np.asarray(jax.jit(
        jyuv.yuv420_to_rgb, static_argnums=(1, 2))(packed, 8, 12)), atol=1e-6)
    np.testing.assert_allclose(dev, host, atol=1e-6)
    # 2x2 blocks of one colour lose nothing to the chroma subsampling
    blocks = frames[:, ::2, ::2].repeat(2, 1).repeat(2, 2)
    back = tyuv.yuv420_to_rgb_host(tyuv.rgb_to_yuv420(blocks), 8, 12) * 255
    assert np.abs(back - blocks).max() < 3


def test_chunked_apply_pads_the_tail_and_keeps_order():
    frames = np.arange(7 * 2, dtype=np.float32).reshape(7, 2)
    seen = []

    def fn(c):
        seen.append(tuple(c.shape))
        return {"a": c * 2, "b": c[:, :1]}

    out = chunked_apply(fn, frames, 3, inflight=1)
    assert seen == [(3, 2)] * 3
    np.testing.assert_array_equal(out["a"], frames * 2)
    np.testing.assert_array_equal(out["b"], frames[:, :1])
    two = chunked_apply(lambda c: (c, c + 1), torch.from_numpy(frames), 4, inflight=0)
    np.testing.assert_array_equal(two[1], frames + 1)
    with pytest.raises(ValueError):
        chunked_apply(fn, frames[:0], 3)


# ---------------------------------------------------------------- facecrop --


@pytest.mark.parametrize("out_u8", [False, True])
def test_warp_crop_matches_jax(out_u8):
    """Boxes inside, across the edge and past the frame; uint8 in, float or
    uint8 out (rounded half to even on both sides)."""
    frames = _face_frames(4, 40, 56, 1)
    center = np.asarray([[28, 20], [2, 3], [50, 36], [28.3, 19.7]], np.float32)
    size = np.asarray([30, 25, 80, 12.5], np.float32)
    want = jfc.warp_crop(frames, center, size, 17, out_u8=out_u8)
    got = tfc.warp_crop(frames, center, size, 17, out_u8=out_u8)
    assert got.dtype == want.dtype and got.shape == (4, 17, 17, 3)
    if out_u8:  # equal but where the float value * 255 lies within 1e-3 of a half
        f = jfc.warp_crop(frames, center, size, 17) * 255.0
        tie = np.abs(f - np.floor(f) - 0.5) < 1e-3
        diff = np.abs(got.astype(int) - want)
        print(f"warp_crop u8: {int((diff > 0).sum())} of {int(tie.sum())} half-way values "
              f"rounded the other way")
        assert diff.max() <= 1 and not (diff > 0)[~tie].any()
    else:
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_smooth_track_matches_jax():
    rng = np.random.default_rng(2)
    center = rng.uniform(20, 40, (30, 2)).astype(np.float32)
    size = rng.uniform(30, 50, 30).astype(np.float32)
    val = (rng.random(30) > 0.3).astype(np.float32)
    for v in (None, val, np.zeros(30, np.float32)):
        for a, b in zip(tfc.smooth_track(center, size, v, 3.0), jfc.smooth_track(center, size, v, 3.0)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tfc.bbox2point_bbox(center.repeat(2, 1))[0],
                                  jfc.bbox2point_bbox(center.repeat(2, 1))[0])


@pytest.mark.parametrize("with_sfd", [False, True])
def test_detect_fullframe_landmarks_matches_jax(nets, with_sfd):
    """FAN on the whole frame resized to 256, or after the S3FD box stage
    (the device top-1 box, the box-centred 256 warp): landmark pixels and
    scores; then ``detect_and_crop``."""
    frames = _face_frames(3, 64, 96, 3)
    jdet = jfan.FanLandmarkDetector(nets["jfan"], nets["jfan_vars"], max_b=2)
    det = FanLandmarkDetector(nets["fan"], max_b=2)
    jbox = jsfd.SfdDetector(nets["jsfd_vars"], threshold=0.0, max_b=2) if with_sfd else None
    box = SfdDetector(nets["sfd"], threshold=0.0, max_b=2) if with_sfd else None
    jl, js = jfc.detect_fullframe_landmarks(jdet, frames, box_detector=jbox)
    tl, ts = tfc.detect_fullframe_landmarks(det, frames, box_detector=box)
    np.testing.assert_allclose(ts, js, atol=2e-4)
    np.testing.assert_allclose(tl, jl, atol=1e-3)
    got = tfc.detect_and_crop(det, frames.astype(np.float32) / 255, 24, box_detector=box)
    want = jfc.detect_and_crop(jdet, frames.astype(np.float32) / 255, 24, box_detector=jbox)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-4)


# ---------------------------------------------------------------- encoder --


@pytest.fixture(scope="module")
def transports(nets):
    """JAX's EmocaPreprocessor codes of the same crops under each transport."""
    crops = _face_frames(5, 32, 32, 4)
    pre = jpre.EmocaPreprocessor(encoder=nets["jenc"], variables=nets["jenc_vars"], max_b=2)
    out = {}
    for t in ("float", "u8", "yuv420"):
        pre.transport = t
        out[t] = pre.encode_frames(crops.astype(np.float32) / 255.0)
    pre.transport = "auto"
    out["auto_u8"] = pre.encode_frames(crops)
    out["packed"] = pre.encode_packed_yuv420(jyuv.rgb_to_yuv420(crops), 32, 32)
    return crops, out


@pytest.mark.parametrize("transport", ["float", "u8", "yuv420", "auto_u8", "packed"])
def test_encode_transports_match_jax(nets, transports, transport):
    crops, want = transports
    pre = tpre.EmocaPreprocessor(encoder=nets["enc"], max_b=2,
                                 transport=transport.replace("auto_u8", "auto"))
    if transport == "packed":
        got = pre.encode_packed_yuv420(tyuv.rgb_to_yuv420(crops), 32, 32)
    elif transport == "auto_u8":
        got = pre.encode_frames(crops)
    else:
        got = pre.encode_frames(crops.astype(np.float32) / 255.0)
    assert sorted(got) == sorted(want[transport]) == ["cam", "exp", "light", "pose", "shape", "tex"]
    for k, v in want[transport].items():
        assert got[k].shape == v.shape
        assert _rel(got[k], v) < 1e-4, k
    if transport == "u8":  # the uint8 and float routes see one image
        for k, v in want["float"].items():
            assert _rel(got[k], v) < 1e-2, k


def test_pseudo_gt_matches_jax(nets, transports):
    crops, want = transports
    val = np.asarray([0.2, 0.0, 1.0, 0.5, 0.3], np.float32)
    pre = tpre.EmocaPreprocessor(encoder=nets["enc"], max_b=2)
    jp = jpre.EmocaPreprocessor(encoder=nets["jenc"], variables=nets["jenc_vars"], max_b=2)
    codes = want["float"]
    got, ref = pre.pseudo_gt(None, val, codes=codes), jp.pseudo_gt(None, val, codes=codes)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7)
    assert (got["pose"][:, :3] == 0).all() and np.ptp(got["shape"], axis=0).max() == 0
    with pytest.raises(ValueError, match="zero"):
        pre.pseudo_gt(None, np.zeros(5, np.float32), codes=codes)
    pre.crash_on_invalid = False
    uniform = pre.pseudo_gt(None, np.zeros(5, np.float32), codes=codes)
    np.testing.assert_allclose(uniform["shape"][0], codes["shape"].mean(0), rtol=1e-5, atol=1e-7)


def test_landmarks_from_codes_matches_jax(transports):
    _, want = transports
    codes = {k: v * 0.3 for k, v in want["float"].items()}
    flame = FlameModel(synthetic_assets(n_shape=8, n_exp=6, n_static_landmarks=51),
                       n_shape=8, n_exp=6)
    jflame = JFlame(jsynthetic(n_shape=8, n_exp=6, n_static_landmarks=51), n_shape=8, n_exp=6)
    got = tpre.landmarks_from_codes(flame, codes, chunk=2)
    ref = jpre.landmarks_from_codes(jflame, codes, chunk=2)
    assert got.shape == (5, 68, 2)
    assert _rel(got, ref) < 1e-4


# ---------------------------------------------------------------- command --


def _write_tree(root, n_frames=5):
    """Two clips of full 64 x 80 frames; the first has a 16 kHz wav."""
    for c in range(2):
        d = os.path.join(root, f"clip{c}")
        os.makedirs(d)
        for t, img in enumerate(_face_frames(n_frames, 64, 80, 10 + c)):
            write_png(os.path.join(d, f"{t:04d}.png"), img)
    with wave.open(os.path.join(root, "clip0", "clip0.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.sin(np.arange(1600) * 0.1) * 3000).astype(np.int16).tobytes())


def _parser_near_ties(bis, crops_png):
    """Pixels of the crops whose BiSeNet top two logits (at 64) are within
    1e-3, at the crops' size."""
    x = torch.from_numpy(crops_png.astype(np.float32) / 255.0).permute(0, 3, 1, 2)
    from avi_talking_tpu_torch.models.bisenet import IMAGENET_MEAN, IMAGENET_STD
    from avi_talking_tpu_torch.ops.resize import resize_bilinear

    x = (resize_bilinear(x, (64, 64)) - torch.from_numpy(IMAGENET_MEAN)[:, None, None]) \
        / torch.from_numpy(IMAGENET_STD)[:, None, None]
    with torch.no_grad():
        s = bis(x).sort(dim=1).values
    gap = (s[:, -1] - s[:, -2]).numpy()
    idx = np.clip(np.round(np.linspace(0, 63, crops_png.shape[1])), 0, 63).astype(np.int64)
    return gap[:, idx][:, :, idx] < 1e-3


def test_preprocess_mead_command_matches_jax(nets, tmp_path):
    """``preprocess-mead --tiny --fan-detect --full-frames --parse-faces`` on
    a 2-clip tree against JAX's ``preprocess_clip_folder`` with the same
    nets: the same files; the landmarks and validity within 1e-4 of their
    largest; the crops (uint8) and masks equal but at near-ties; the codes
    within 1e-4 of JAX's encoder on the port's crops (a crop value rounded
    the other way at a half moves the codes by about 1e-4, so against JAX's
    own crops they are held at 1e-2)."""
    src = str(tmp_path / "src")
    _write_tree(src)
    out = str(tmp_path / "port")
    rc = main(["preprocess-mead", "--src", src, "--out", out, "--tiny", "--device", "cpu",
               "--size", "32", "--max-b", "4", "--fan-detect", "--full-frames",
               "--parse-faces"])
    assert rc == 0
    ref = str(tmp_path / "jax")
    jp = jpre.EmocaPreprocessor(encoder=nets["jenc"], variables=nets["jenc_vars"], max_b=4)
    jdet = jfan.FanLandmarkDetector(nets["jfan"], nets["jfan_vars"], max_b=4)
    for c in ("clip0", "clip1"):
        jpre.preprocess_clip_folder(
            jp, os.path.join(src, c), ref, flame=JFlame(jsynthetic(
                n_shape=8, n_exp=6, n_static_landmarks=51), n_shape=8, n_exp=6),
            detector=jdet, crop_full_frames=True, crop_size=32, crop_scale=1.25,
            crop_smooth_sigma=3.0, parser=jbis.FaceParser(nets["jbis_vars"], size=64, max_b=4))
    files = sorted(os.path.relpath(p, out) for p in glob.glob(out + "/**/*.*", recursive=True))
    assert files == sorted(os.path.relpath(p, ref)
                           for p in glob.glob(ref + "/**/*.*", recursive=True))
    assert "clip0/clip0.wav" in files and "clip1/masks/00004_000.png" in files
    flips = 0
    for c in ("clip0", "clip1"):  # the codes: JAX's encoder on the port's crops
        crops = np.stack([read_png(p) for p in sorted(glob.glob(f"{out}/{c}/detections/*.png"))])
        want = jp.pseudo_gt(crops, np.load(f"{out}/{c}/validity.npy"))
        for t in range(len(crops)):
            for k in ("exp", "pose", "shape", "cam"):
                got = np.load(f"{out}/{c}/EMOCA_v2_lr_mse_20/{t:05d}_000/{k}.npy")
                assert _rel(got, want[k][t]) < 1e-4, (c, t, k)
                assert _rel(got, np.load(f"{ref}/{c}/EMOCA_v2_lr_mse_20/{t:05d}_000/{k}.npy")) < 1e-2
    for f in files:
        a, b = os.path.join(out, f), os.path.join(ref, f)
        if f.endswith(("landmarks.npy", "validity.npy")):
            assert _rel(np.load(a), np.load(b)) < 1e-4, f
        elif f.endswith(".wav"):
            assert open(a, "rb").read() == open(b, "rb").read()
        elif "/detections/" in f:
            d = np.abs(read_png(a).astype(int) - read_png(b))
            assert d.max() <= 1, f
            flips += int((d > 0).sum())
        elif "/masks/" in f:
            crop = read_png(a.replace("/masks/", "/detections/"))
            tie = _parser_near_ties(nets["bis"], crop[None])[0]
            ma, mb = read_png(a), read_png(b)
            np.testing.assert_array_equal(ma[~tie], mb[~tie], err_msg=f)
            flips += int((ma != mb).sum())
    print(f"preprocess-mead: {flips} crop / mask values at rounding or argmax near-ties")


def test_preprocess_mead_videos_match_jax(nets, tmp_path, monkeypatch):
    """``--videos`` through a stub ffmpeg (the "video" is an npy of packed
    yuv420p rows): the frame-free route's codes against JAX's, the wav
    demuxed; without ffmpeg the command stops with its message."""
    _install_stubs(tmp_path, monkeypatch)
    src = tmp_path / "vids"
    src.mkdir()
    _make_video(src / "talk.mp4", _packed(6, seed=3))
    out = str(tmp_path / "port")
    assert main(["preprocess-mead", "--videos", "--src", str(src), "--out", out, "--tiny",
                 "--device", "cpu", "--max-b", "4", "--no-detections"]) == 0
    jp = jpre.EmocaPreprocessor(encoder=nets["jenc"], variables=nets["jenc_vars"], max_b=4)
    ref = str(tmp_path / "jax")
    jpre.preprocess_clip_video(jp, str(src / "talk.mp4"), ref, write_detections=False)
    names = sorted(os.listdir(os.path.join(out, "talk", "EMOCA_v2_lr_mse_20")))
    assert len(names) == 6 and os.path.getsize(os.path.join(out, "talk", "talk.wav")) > 44
    for n in names:
        for k in ("exp", "pose", "shape", "cam"):
            a = np.load(os.path.join(out, "talk", "EMOCA_v2_lr_mse_20", n, f"{k}.npy"))
            b = np.load(os.path.join(ref, "talk", "EMOCA_v2_lr_mse_20", n, f"{k}.npy"))
            assert _rel(a, b) < 1e-4
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(SystemExit, match="ffmpeg not found"):
        main(["preprocess-mead", "--videos", "--src", str(src), "--out", out, "--tiny",
              "--device", "cpu"])


def test_preprocess_mead_needs_a_card_without_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["preprocess-mead", "--src", str(tmp_path), "--out", str(tmp_path), "--tiny"])


@pytest.mark.parametrize("kind", ["torch_file", "checkpoint_dir"])
def test_preprocess_mead_reads_encoder_weights(tmp_path, kind):
    """``--checkpoint``: a reference torch file (the towers found under
    ``model.``) or the port's checkpoint directory; the codes are the given
    encoder's."""
    from avi_talking_tpu_torch.infra.checkpoint import save_checkpoint

    enc = _seeded(lambda: EmocaEncoder(n_exp=6), 5)
    if kind == "torch_file":
        ck = str(tmp_path / "emoca.ckpt")
        torch.save({"state_dict": {"model." + k: v for k, v in enc.state_dict().items()}}, ck)
    else:
        ck = str(tmp_path / "ck")
        save_checkpoint(ck, {"encoder": enc.state_dict()})
    src = tmp_path / "src" / "clip"
    src.mkdir(parents=True)
    crops = _face_frames(3, 32, 32, 8)
    for t, img in enumerate(crops):
        write_png(str(src / f"{t:04d}.png"), img)
    out = str(tmp_path / "out")
    assert main(["preprocess-mead", "--src", str(tmp_path / "src"), "--out", out, "--tiny",
                 "--device", "cpu", "--size", "32", "--max-b", "2", "--checkpoint", ck]) == 0
    want = tpre.EmocaPreprocessor(encoder=enc, max_b=2).pseudo_gt(crops)
    for t in range(3):
        for k in ("exp", "pose", "shape", "cam"):
            got = np.load(os.path.join(out, "clip", "EMOCA_v2_lr_mse_20", f"{t:05d}_000", f"{k}.npy"))
            np.testing.assert_array_equal(got, want[k][t])
