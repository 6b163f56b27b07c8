"""Port parity of the preprocessing nets: FAN's landmark net, its heatmap
decode and detector (``models.fan_landmarks``), S3FD with its prior
decode, NMS and both top-1 box routes (``models.sfd``), BiSeNet and its
face parser (``models.bisenet``), and their reference importers.

The port's seeded weights (BatchNorm statistics perturbed) go to JAX
through JAX's own reference importers; ``infra.jax_params`` carries them
back, bit for bit. Discrete outputs (argmax landmarks, labels, boxes) are
held exactly where the top two values are more than 1e-5 apart; the flips
elsewhere are counted and printed, and the continuous values held."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.models import bisenet as jbis
from avi_talking_tpu.models import fan_landmarks as jfan
from avi_talking_tpu.models import sfd as jsfd
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.infra.jax_params import (bisenet_state_from_jax,
                                                    fan_landmarks_state_from_jax,
                                                    sfd_state_from_jax)
from avi_talking_tpu_torch.models import bisenet as tbis
from avi_talking_tpu_torch.models import fan_landmarks as tfan
from avi_talking_tpu_torch.models import sfd as tsfd
from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
FAN_KW = dict(num_modules=2, depth=2, stem_features=8, features=16)


def _np_state(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _perturb_norms(module, seed):
    """Random BatchNorm affine and running statistics (a fresh init has
    mean 0, var 1, weight 1, bias 0, which a parity test would not reach)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=g) * 0.5 + 0.75)
                m.weight.copy_(torch.rand(n, generator=g) * 0.5 + 0.75)
                m.bias.copy_(torch.randn(n, generator=g) * 0.1)
    return module


def _seeded(factory, seed):
    return _perturb_norms(random_module(factory, CPU, torch.Generator().manual_seed(seed)),
                          seed + 100)


def _assert_state_equal(got, module):
    want = module.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v.numpy(), err_msg=k)


def _top2_gap(x, axis):
    s = np.sort(x, axis=axis)
    return np.take(s, -1, axis=axis) - np.take(s, -2, axis=axis)


# ------------------------------------------------------------------ FAN --


@pytest.fixture(scope="module")
def fan_case():
    """The port's seeded FAN (2 modules of depth 2, widths 8 / 16), JAX's
    variables from JAX's importer, frames, and JAX's heatmaps and detector
    outputs (resized 48 -> 32, antialiased, as float and uint8)."""
    net = _seeded(lambda: tfan.FanLandmarkNet(**FAN_KW), 1)
    jvars = jfan.fan_landmarks_params_from_torch(_np_state(net), num_modules=2, depth=2)
    jnet = jfan.FanLandmarkNet(num_modules=2, depth=2, stem_features=8, features=16)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    frames = rng.uniform(0, 1, (5, 48, 48, 3)).astype(np.float32)
    frames_u8 = (frames * 255).astype(np.uint8)
    hm = np.asarray(jax.jit(lambda v, a: jnet.apply(v, a, train=False))(jvars, x))
    jdet = jfan.FanLandmarkDetector(jnet, jvars, max_b=2, input_size=32)
    return dict(net=net, jvars=jvars, x=x, hm=hm, frames=frames, frames_u8=frames_u8,
                det=jdet(frames), det_u8=jdet(frames_u8))


def test_fan_landmark_net_matches_jax(fan_case):
    c = fan_case
    with torch.no_grad():
        got = c["net"](torch.from_numpy(c["x"]).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == c["hm"].shape == (3, 8, 8, 68)
    np.testing.assert_allclose(got, c["hm"], atol=2e-4)


def test_fan_importers_round_trip(fan_case):
    """JAX's variables carry back to the port's state bit for bit, and the
    port's importer reads a face_alignment file nested under
    ``state_dict``."""
    c = fan_case
    _assert_state_equal(fan_landmarks_state_from_jax(c["jvars"]), c["net"])
    sd = {"state_dict": {k: torch.from_numpy(v) for k, v in _np_state(c["net"]).items()}}
    _assert_state_equal(tfan.fan_landmarks_state_from_torch(sd, num_modules=2, depth=2),
                        c["net"])


def _built_heatmaps():
    """Heatmaps with peaks on every edge and corner, flat neighbours (a
    0 shift), repeated maxima (the first wins) and interior peaks."""
    rng = np.random.default_rng(5)
    hm = rng.uniform(0, 0.5, (2, 9, 11, 8)).astype(np.float32)
    peaks = [(0, 0), (0, 10), (8, 0), (8, 10), (0, 5), (4, 0), (4, 10), (8, 5)]
    for lm, (y, x) in enumerate(peaks):
        hm[0, y, x, lm] = 1.0
    for lm in range(8):
        y, x = 1 + lm % 7, 1 + (2 * lm) % 9
        hm[1, y, x, lm] = 1.0
        if lm % 2:  # equal neighbours: sign 0
            hm[1, y, x - 1, lm] = hm[1, y, x + 1, lm] = 0.7
        if lm % 3 == 0:  # a second, later maximum
            hm[1, 8, 10, lm] = 1.0
    return hm


def test_decode_heatmaps_matches_jax():
    hm = _built_heatmaps()
    jp, js = jax.jit(jfan.decode_heatmaps)(hm)
    tp, ts = tfan.decode_heatmaps(torch.from_numpy(hm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


@pytest.mark.parametrize("u8", [False, True])
def test_fan_detector_matches_jax(fan_case, u8):
    """The detector on 48^2 frames resized to 32 (JAX's antialiased shrink),
    float and uint8: scores within 2e-4; landmarks equal where the heatmap's
    top two and the peak's neighbours are more than 1e-5 apart."""
    c = fan_case
    frames = c["frames_u8" if u8 else "frames"]
    jl, js = c["det_u8" if u8 else "det"]
    det = tfan.FanLandmarkDetector(c["net"], max_b=2, input_size=32)
    tl, ts = det(frames)
    assert tl.shape == (5, 68, 2) and ts.shape == (5, 68)
    np.testing.assert_allclose(ts, js, atol=2e-4)
    with torch.no_grad():
        x = torch.from_numpy(frames).float() / (255.0 if u8 else 1.0)
        x = tfan.resize_bilinear(x.permute(0, 3, 1, 2), (32, 32))
        hm = c["net"](x).permute(0, 2, 3, 1).reshape(5, 64, 68).numpy()
    clear = _top2_gap(hm, 1) > 1e-5
    idx = hm.argmax(1)
    for dx in (-1, 1, -8, 8):  # the neighbours the shift reads
        nb = np.take_along_axis(hm, np.clip(idx + dx, 0, 63)[:, None], 1)[:, 0]
        opp = np.take_along_axis(hm, np.clip(idx - dx, 0, 63)[:, None], 1)[:, 0]
        clear &= np.abs(nb - opp) > 1e-5
    flips = int((np.abs(tl - jl).max(-1) > 1e-5)[clear].sum())
    print(f"fan detector: {int((~clear).sum())} near-tie landmarks of {clear.size}")
    assert clear.mean() > 0.5 and flips == 0
    np.testing.assert_allclose(tl[clear], jl[clear], atol=1e-5)


# ------------------------------------------------------------------ SFD --


@pytest.fixture(scope="module")
def sfd_case():
    net = random_module(tsfd.S3FD, CPU, torch.Generator().manual_seed(3))
    with torch.no_grad():  # the L2Norm scales off their constant init
        for name in ("conv3_3_norm", "conv4_3_norm", "conv5_3_norm"):
            w = getattr(net, name).weight
            w.mul_(torch.rand(w.shape, generator=torch.Generator().manual_seed(4)) + 0.5)
    jvars = jsfd.sfd_params_from_torch(_np_state(net))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32) * 50
    frames = rng.uniform(0, 1, (5, 64, 96, 3)).astype(np.float32)
    maps = [np.asarray(m) for m in jax.jit(jsfd.S3FD().apply)(jvars, x)]
    jdet = jsfd.SfdDetector(jvars, threshold=0.0, max_b=2)
    return dict(net=net, jvars=jvars, x=x, frames=frames, maps=maps,
                boxes=jdet(frames), best=jdet.best_box(frames),
                best_dev=jdet.best_box_device(frames))


def test_s3fd_matches_jax(sfd_case):
    c = sfd_case
    with torch.no_grad():
        got = c["net"](torch.from_numpy(c["x"]).permute(0, 3, 1, 2))
    assert len(got) == 12
    for g, r in zip(got, c["maps"]):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), r, rtol=2e-4, atol=5e-4)


def test_sfd_importers_round_trip(sfd_case):
    c = sfd_case
    _assert_state_equal(sfd_state_from_jax(c["jvars"]), c["net"])
    sd = {"state_dict": {k: torch.from_numpy(v) for k, v in _np_state(c["net"]).items()}}
    _assert_state_equal(tsfd.sfd_state_from_torch(sd), c["net"])


def _clear_frames(net, frames):
    """Frames whose best face score beats the runner-up anchor by > 1e-5."""
    det = tsfd.SfdDetector(net, max_b=2)
    with torch.no_grad():
        maps = det._maps(torch.from_numpy(frames))
    scores = np.concatenate([m[:, 1].reshape(len(frames), -1).numpy() for m in maps[0::2]], 1)
    return _top2_gap(scores, 1) > 1e-5


def test_sfd_detector_matches_jax(sfd_case):
    """The host decode (NMS, threshold 0), ``best_box`` and the device
    top-1 ``best_box_device`` against JAX's, and the two routes against
    each other."""
    c = sfd_case
    det = tsfd.SfdDetector(c["net"], threshold=0.0, max_b=2)
    boxes, best, best_dev = det(c["frames"]), det.best_box(c["frames"]), \
        det.best_box_device(c["frames"])
    clear = _clear_frames(c["net"], c["frames"])
    print(f"sfd: {int((~clear).sum())} of {len(clear)} frames with a near-tie top anchor")
    assert clear.sum() >= 3
    for t in np.flatnonzero(clear):
        np.testing.assert_allclose(boxes[t][0], c["boxes"][t][0], rtol=2e-4, atol=5e-4)
        np.testing.assert_allclose(best[t], c["best"][t], rtol=2e-4, atol=5e-4)
        np.testing.assert_allclose(best_dev[t], c["best_dev"][t], rtol=2e-4, atol=5e-4)
        np.testing.assert_allclose(best_dev[t], best[t], rtol=1e-5, atol=1e-4)
    assert [len(b) for b in boxes] == [len(b) for b in c["boxes"]]


def test_sfd_best_box_falls_back():
    """A frame without a face above the threshold takes the previous
    frame's box, and the whole frame before any face, on both routes."""
    net = random_module(tsfd.S3FD, CPU, torch.Generator().manual_seed(3))
    frames = np.random.default_rng(2).uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    jdet = jsfd.SfdDetector(jsfd.sfd_params_from_torch(_np_state(net)), threshold=1.01)
    det = tsfd.SfdDetector(net, threshold=1.01)
    for got, want in ((det.best_box(frames), jdet.best_box(frames)),
                      (det.best_box_device(frames), jdet.best_box_device(frames))):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:, :4], [[0, 0, 63, 63]] * 3)


def test_decode_priors_and_nms_match_jax():
    rng = np.random.default_rng(4)
    loc = rng.standard_normal((40, 4)).astype(np.float32)
    priors = np.abs(rng.standard_normal((40, 4)).astype(np.float32)) * 30 + 4
    np.testing.assert_array_equal(tsfd.decode_priors(loc, priors),
                                  jsfd.decode_priors(loc, priors))
    xy = rng.uniform(0, 60, (40, 2))
    dets = np.concatenate([xy, xy + rng.uniform(5, 30, (40, 2)), rng.uniform(0, 1, (40, 1))],
                          1).astype(np.float32)
    dets[5] = dets[3]  # an exact duplicate
    assert tsfd.nms(dets, 0.3) == jsfd.nms(dets, 0.3)
    assert tsfd.nms(dets[:0], 0.3) == jsfd.nms(dets[:0], 0.3) == []


# -------------------------------------------------------------- BiSeNet --


@pytest.fixture(scope="module")
def bisenet_case():
    net = _seeded(tbis.BiSeNet, 2)
    sd = _np_state(net)
    sd["conv_out16.conv_out.weight"] = np.zeros((19, 64, 1, 1), np.float32)  # aux head
    jvars = jbis.bisenet_params_from_torch(sd)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    crops = rng.uniform(0, 1, (3, 48, 48, 3)).astype(np.float32)
    logits = np.asarray(jax.jit(jbis.BiSeNet().apply)(jvars, x))
    parser = jbis.FaceParser(jvars, size=64, max_b=2)
    jlog = jax.jit(lambda v, a: jbis.BiSeNet().apply(v, (jax.image.resize(
        a, (a.shape[0], 64, 64, 3), "bilinear") - jbis.IMAGENET_MEAN) / jbis.IMAGENET_STD))
    return dict(net=net, sd=sd, jvars=jvars, x=x, logits=logits, crops=crops,
                parsed=parser(crops), crop_logits=np.asarray(jlog(jvars, crops)))


def test_bisenet_matches_jax(bisenet_case):
    c = bisenet_case
    with torch.no_grad():
        got = c["net"](torch.from_numpy(c["x"]).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 64, 64, 19)
    np.testing.assert_allclose(got, c["logits"], rtol=2e-4, atol=2e-4)


def test_bisenet_importers_round_trip(bisenet_case):
    c = bisenet_case
    _assert_state_equal(bisenet_state_from_jax(c["jvars"]), c["net"])
    _assert_state_equal(tbis.bisenet_state_from_torch(c["sd"]), c["net"])


def test_upsample_bilinear_ac_matches_jax():
    x = np.random.default_rng(6).standard_normal((2, 7, 5, 3)).astype(np.float32)
    want = np.asarray(jbis.upsample_bilinear_ac(jnp.asarray(x), 13, 9))
    got = tbis.upsample_bilinear_ac(torch.from_numpy(x).permute(0, 3, 1, 2), 13, 9)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-6)


def test_face_parser_matches_jax(bisenet_case):
    """Labels and masks of 48^2 crops parsed at 64 (resized up, labels back
    by nearest sampling): equal wherever JAX's top two logits are more than
    1e-3 apart (the logits agree to 2e-4)."""
    c = bisenet_case
    seg, mask = tbis.FaceParser(c["net"], size=64, max_b=2)(c["crops"])
    jseg, jmask = c["parsed"]
    assert seg.dtype == np.uint8 and seg.shape == jseg.shape == (3, 48, 48)
    idx = np.clip(np.round(np.linspace(0, 63, 48)), 0, 63).astype(np.int64)
    gap = _top2_gap(c["crop_logits"], -1)[:, idx][:, :, idx]
    clear = gap > 1e-3
    print(f"face parser: {int((seg != jseg)[~clear].sum())} flips among "
          f"{int((~clear).sum())} near-tie pixels of {seg.size}")
    np.testing.assert_array_equal(seg[clear], jseg[clear])
    np.testing.assert_array_equal(mask[clear], jmask[clear])
    np.testing.assert_array_equal(mask, np.logical_not(np.isin(seg, tbis.DISCARDED_LABELS)))
