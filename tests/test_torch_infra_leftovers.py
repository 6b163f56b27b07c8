"""Port parity, the single-process leftovers: ``audio.specaugment``
(bit-equal masks), ``infra.config`` (round trip, overrides, refusals),
``infra.guards`` (each guard; ``checkify_step`` finds what JAX's
``float_checks`` finds), ``infra.meters`` (``Meter``'s JSONL equal to JAX's,
``profile_region`` in a torch.profiler trace, ``trace``, the profiler
server's refusal), ``data.loop_utils``, the rotations, ``resample_features``,
``AFFECTNET_EMOTIONS``, ``prefetch_to_device`` on the CPU, and
``lbs(detach_pose_correctives=True)``'s gradient against ``jax.grad``."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.audio import specaugment as jspec
from avi_talking_tpu.core import assets as jassets
from avi_talking_tpu.core import flame as jflame
from avi_talking_tpu.core import rotations as jrot
from avi_talking_tpu.data import loop_utils as jloop
from avi_talking_tpu.infra import config as jconfig
from avi_talking_tpu.infra import guards as jguards
from avi_talking_tpu.infra import meters as jmeters
from avi_talking_tpu.models import conditioning as jcond
from avi_talking_tpu.models.emote import EmoteConfig as JEmoteConfig
from avi_talking_tpu.ops import resample as jres
from avi_talking_tpu_torch.audio import specaugment as tspec
from avi_talking_tpu_torch.core import assets as tassets
from avi_talking_tpu_torch.core import flame as tflame
from avi_talking_tpu_torch.core import rotations as trot
from avi_talking_tpu_torch.data import loop_utils as tloop
from avi_talking_tpu_torch.data.batching import prefetch_to_device
from avi_talking_tpu_torch.infra import config as tconfig
from avi_talking_tpu_torch.infra import guards as tguards
from avi_talking_tpu_torch.infra import meters as tmeters
from avi_talking_tpu_torch.models import conditioning as tcond
from avi_talking_tpu_torch.models.emote import EmoteConfig
from avi_talking_tpu_torch.ops import resample as tres
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("shape,p,length,min_masks,seed", [
    ((1, 399), 0.5, 2, 2, 3), ((8, 64), 0.5, 2, 2, 4), ((4, 100), 0.2, 10, 2, 0),
    ((3, 12), 0.05, 10, 2, 1), ((2, 30), 0.1, 4, 1, 5),
])
def test_compute_mask_indices_bit_equal(shape, p, length, min_masks, seed):
    got = tspec.compute_mask_indices(shape, p, length, min_masks, np.random.default_rng(seed))
    ref = jspec.compute_mask_indices(shape, p, length, min_masks, np.random.default_rng(seed))
    assert got.dtype == bool and got.shape == shape
    np.testing.assert_array_equal(got, ref)


# --- infra.config ---


def _jax_dict(cfg):
    """JAX's ``to_dict`` less wav2vec2's ``use_pallas_attention`` (a TPU
    gate the port has no counterpart of)."""
    d = jconfig.to_dict(cfg)
    del d["wav2vec2"]["use_pallas_attention"]
    return d


def test_config_round_trip_and_overrides(tmp_path):
    """``to_dict`` equal to JAX's; ``save`` / ``load`` give the config back
    (nested dataclasses, lists as tuples) and JAX reads the file; overrides
    as JAX applies them."""
    cfg = EmoteConfig.tiny()
    assert tconfig.to_dict(cfg) == _jax_dict(JEmoteConfig.tiny())
    path = str(tmp_path / "cfg.json")
    tconfig.save_config(cfg, path)
    assert tconfig.load_config(EmoteConfig, path) == cfg
    assert jconfig.load_config(JEmoteConfig, path) == JEmoteConfig.tiny()
    ov = ["feature_dim=48", "flint.nhead=2", "wav2vec2.conv_dim=[8, 8, 8]",
          "squash_type=stack_linear"]
    got, ref = tconfig.apply_overrides(cfg, ov), jconfig.apply_overrides(JEmoteConfig.tiny(), ov)
    assert tconfig.to_dict(got) == _jax_dict(ref)
    assert got.flint.nhead == 2 and got.wav2vec2.conv_dim == (8, 8, 8)


def test_config_refusals():
    cfg = EmoteConfig.tiny()
    with pytest.raises(KeyError, match="unknown override key"):
        tconfig.apply_overrides(cfg, ["flint.no_such=1"])
    with pytest.raises(KeyError, match="unknown config field EmoteConfig.bogus"):
        tconfig.from_dict(EmoteConfig, {"bogus": 1})


# --- infra.guards ---


def test_check_loss_and_tree_finite():
    tguards.check_loss(torch.tensor(1.5))
    for bad in (float("nan"), torch.tensor(float("inf"))):
        with pytest.raises(ValueError, match="NaN/inf loss"):
            tguards.check_loss(bad)
    tree = {"enc": {"w": torch.ones(2), "b": torch.tensor([0.0, float("nan")])},
            "steps": torch.tensor([3]), "name": "x", "layers": [torch.zeros(1),
                                                                 torch.full((2,), float("inf"))]}
    with pytest.raises(ValueError) as err:
        tguards.check_tree_finite(tree, "params")
    assert "params" in str(err.value) and "'enc/b'" in str(err.value)
    assert "'layers/1'" in str(err.value) and "enc/w" not in str(err.value)
    module = torch.nn.Linear(2, 2)
    tguards.check_tree_finite(module)
    with torch.no_grad():
        module.bias[0] = float("nan")
    with pytest.raises(ValueError, match="'bias'"):
        tguards.check_tree_finite(module.state_dict())


def test_guard_metrics_matches_jax():
    m = {"loss": np.float32(np.nan), "acc": np.float32(0.5), "inf": np.float32(-np.inf),
         "count": 3}
    ref = jguards.guard_metrics({k: jnp.asarray(v) if k != "count" else v for k, v in m.items()})
    got = tguards.guard_metrics({k: torch.tensor(v) if k != "count" else v for k, v in m.items()})
    for k in ("loss", "acc", "inf"):
        assert float(got[k]) == float(ref[k])
    assert got["count"] == 3


def test_finite_or_debug(capsys):
    x = torch.tensor([1.0, float("nan")])
    assert tguards.finite_or_debug(x, "decoder") is x
    assert "[nan-guard] non-finite output at stage decoder" in capsys.readouterr().out
    tguards.finite_or_debug(torch.ones(2), "decoder")
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("case", ["nan", "div", "clean"])
def test_checkify_step_finds_what_jax_finds(case):
    """A NaN planted inside the step (not in its output: ``nan_to_num``
    hides it there) or a division by zero: both packages report an error;
    a clean step none. ``throw`` raises."""
    x = np.array([1.0, -1.0 if case == "nan" else 2.0, 3.0], np.float32)
    d = np.array([1.0, 0.0 if case == "div" else 2.0, 4.0], np.float32)

    def jstep(a, b):
        return jnp.nan_to_num(jnp.log(a) / b).sum()

    def tstep(a, b):
        return torch.nan_to_num(torch.log(a) / b).sum()

    jerr, jout = jax.jit(jguards.checkify_step(jstep))(jnp.asarray(x), jnp.asarray(d))
    terr, tout = tguards.checkify_step(tstep)(torch.from_numpy(x), torch.from_numpy(d))
    assert (jerr.get() is None) == (terr.get() is None) == (case == "clean")
    np.testing.assert_allclose(float(tout), float(jout), rtol=1e-6)
    if case == "clean":
        terr.throw()
        return
    with pytest.raises(FloatingPointError, match="nan generated" if case == "nan" else "division"):
        terr.throw()


# --- infra.meters ---


def test_meter_jsonl_matches_jax(tmp_path, monkeypatch):
    """``Meter`` averages finite values and writes JAX's JSONL lines (time
    aside); TensorBoard's import is blocked (it imports TensorFlow, tens of
    seconds on one core), so both write only the JSONL."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    lines = {}
    for name, mod in (("jax", jmeters), ("port", tmeters)):
        logdir = tmp_path / name
        writer = mod.set_summary_writer(str(logdir))
        m = mod.Meter("flint/loss")
        for v in (1.0, float("nan"), 2.0, 4.5):
            m.write(v)
        m.flush(50)
        m.flush(51)  # nothing left: no line
        m.write(3.0)
        m.flush(100)
        if name == "port":
            writer.close()
            monkeypatch.setattr(tmeters, "_installed", None)
        else:
            jmeters._jsonl.close()
            monkeypatch.setattr(jmeters, "_jsonl", None)
            monkeypatch.setattr(jmeters, "_writer", None)
        lines[name] = [{k: v for k, v in json.loads(line).items() if k != "t"}
                       for line in (logdir / "scalars.jsonl").read_text().splitlines()]
    assert lines["port"] == lines["jax"] == [{"step": 50, "flint/loss": 2.5},
                                             {"step": 100, "flint/loss": 3.0}]


def test_meter_writes_to_its_own_writer(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with tmeters.ScalarWriter(str(tmp_path)) as w:
        m = tmeters.Meter("a", w)
        m.write(torch.tensor(2.0))
        m.flush(7)
    assert json.loads((tmp_path / "scalars.jsonl").read_text())["a"] == 2.0


def test_profile_region_and_trace(tmp_path):
    """The region's name is a range of a torch.profiler trace, its wall time
    is kept; ``trace`` writes a trace file under its directory; the profiler
    server refuses and names ``trace``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tmeters.profile_region("flint_step") as r:
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert r.elapsed > 0
    assert any(e.key == "flint_step" for e in prof.key_averages())
    with tmeters.trace(str(tmp_path / "tb")):
        torch.ones(8) * 2
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path / "tb"))
    with pytest.raises(NotImplementedError, match="trace"):
        tmeters.start_profiler_server(9999)


# --- the small helpers ---


@pytest.mark.parametrize("length,n", [(5, 23), (1, 4), (7, 7), (3, 2)])
def test_loopback_frames_match_jax(length, n):
    frames = np.arange(length * 2, dtype=np.float32).reshape(length, 2)
    np.testing.assert_array_equal(tloop.loopback_frames(frames, n),
                                  jloop.loopback_frames(frames, n))
    np.testing.assert_array_equal(tloop.loopback_frames(torch.from_numpy(frames), n).numpy(),
                                  jloop.loopback_frames(frames, n))
    np.testing.assert_array_equal(tloop.calc_loop_idx(np.arange(n), length),
                                  jloop.calc_loop_idx(np.arange(n), length))


def test_rotations_match_jax():
    rng = np.random.default_rng(0)
    aa = rng.standard_normal((2, 5, 3)).astype(np.float32)
    d6 = rng.standard_normal((4, 6)).astype(np.float32)
    m = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa)))
    np.testing.assert_allclose(trot.axis_angle_to_matrix(torch.from_numpy(aa)).numpy(), m,
                               atol=1e-6, rtol=0)
    r6 = trot.rotation_6d_to_matrix(torch.from_numpy(d6))
    np.testing.assert_allclose(r6.numpy(), np.asarray(jrot.rotation_6d_to_matrix(jnp.asarray(d6))),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(trot.matrix_to_rotation_6d(torch.from_numpy(m)).numpy(),
                                  np.asarray(jrot.matrix_to_rotation_6d(jnp.asarray(m))))
    np.testing.assert_allclose((r6 @ r6.transpose(-1, -2)).numpy(), np.broadcast_to(np.eye(3),
                               (4, 3, 3)), atol=1e-5)


@pytest.mark.parametrize("T,fps_in,fps_out,out_len", [(50, 50, 25, None), (33, 50, 30, None),
                                                      (20, 50, 25, 17)])
def test_resample_features_matches_jax(T, fps_in, fps_out, out_len):
    x = np.random.default_rng(T).standard_normal((2, T, 5)).astype(np.float32)
    ref = np.asarray(jres.resample_features(jnp.asarray(x), fps_in, fps_out, out_len))
    got = tres.resample_features(torch.from_numpy(x), fps_in, fps_out, out_len).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_affectnet_emotions_match_jax():
    assert tcond.AFFECTNET_EMOTIONS == jcond.AFFECTNET_EMOTIONS


def test_prefetch_to_device_on_the_cpu():
    """Order kept, array leaves as tensors on the device, other leaves
    passed through, the iterator's error raised in the consumer."""
    def batches():
        for i in range(5):
            yield {"x": np.full((2, 3), i, np.float32), "t": (torch.tensor([i]),),
                   "path": f"clip{i}"}
        raise OSError("disk gone")

    seen = []
    with pytest.raises(OSError, match="disk gone"):
        for b in prefetch_to_device(batches(), size=2, device="cpu"):
            assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
            assert isinstance(b["t"], tuple) and isinstance(b["t"][0], torch.Tensor)
            seen.append((int(b["x"][0, 0]), int(b["t"][0]), b["path"]))
    assert seen == [(i, i, f"clip{i}") for i in range(5)]


def test_prefetch_to_device_needs_a_card_or_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(prefetch_to_device(iter([{"x": np.zeros(1)}])))


# --- lbs(detach_pose_correctives=True) ---


@pytest.mark.parametrize("detach", [False, True])
def test_lbs_detach_pose_correctives_gradient_matches_jax(detach):
    """The vertices' gradient with respect to the pose through ``lbs``:
    within 1e-5 of ``jax.grad``'s, and with ``detach`` it differs from the
    undetached one (the pose correctives' share is gone)."""
    ja = jassets.synthetic_assets(num_vertices=30, n_shape=4, n_exp=3, num_faces=40)
    ta = tassets.synthetic_assets(num_vertices=30, n_shape=4, n_exp=3, num_faces=40)
    rng = np.random.default_rng(1)
    betas = rng.standard_normal((2, 7)).astype(np.float32)
    pose = (rng.standard_normal((2, 15)) * 0.3).astype(np.float32)
    w = rng.standard_normal((2, 30, 3)).astype(np.float32)

    def jloss(p, d):
        return jnp.sum(jflame.lbs(jnp.asarray(betas), p, ja, d)[0] * w)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(pose), detach))
    tp = torch.from_numpy(pose).requires_grad_()
    (tflame.lbs(torch.from_numpy(betas), tp, ta, detach_pose_correctives=detach)[0]
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), ref, atol=1e-5, rtol=0)
    other = np.asarray(jax.grad(jloss)(jnp.asarray(pose), not detach))
    assert np.abs(ref - other).max() > 1e-4

