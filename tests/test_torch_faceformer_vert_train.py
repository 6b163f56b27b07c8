"""Port parity, the vertex-space FaceFormer's training step as
``train-faceformer-vert`` composes it: three steps of
``FaceFormerVertTrainer`` with ``train.optim.adam`` against the JAX
command's loss under ``optax.adam(1e-4)`` from carried weights, in the plain,
``--disentangle`` (JAX's permutations passed in) and ``--mead-root
--emo-cls`` modes (the loss and its terms at each step and every parameter
after three, < 1e-4, the FaceFormer trainer test's tolerance); three pretrain steps of the
emotion head, whose BatchNorm statistics train as weights as in JAX; and the
command on the CPU at the tiny config in every mode (synthetic,
``--disentangle``, a VOCASET ``--root``, ``--mead-root`` with ``--emo-cls``,
the pretrain stage), its checkpoints (``--ckpt-dir``, the pretrain ->
``--head-checkpoint`` round trip, a reference-named ``--fan-checkpoint``),
the first MEAD batch against the JAX command's, and what it refuses."""

import argparse
import ast
import pickle
import wave

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avi_talking_tpu.core import FlameModel as JFlame
from avi_talking_tpu.core import synthetic_assets as j_synthetic_assets
from avi_talking_tpu.data import MeadEmocaDataset as JMead
from avi_talking_tpu.data import batch_iterator as j_batch_iterator
from avi_talking_tpu.data.train_batches import FaceFormerBatchBuilder as JBuilder
from avi_talking_tpu.models import faceformer_vert as jffv
from avi_talking_tpu.models.fan_encoder import FanEncoder as JFan
from avi_talking_tpu.train import emo_cls as jemo
from avi_talking_tpu_torch.cli import main as cli_main
from avi_talking_tpu_torch.cli.train_faceformer_vert import batch_source
from avi_talking_tpu_torch.core.assets import synthetic_assets as t_synthetic_assets
from avi_talking_tpu_torch.core.flame import FlameModel as TFlame
from avi_talking_tpu_torch.infra.checkpoint import restore_checkpoint
from avi_talking_tpu_torch.infra.jax_params import (
    emo_cls_head_state_from_jax,
    fan_encoder_state_from_jax,
    faceformer_vert_state_from_jax,
)
from avi_talking_tpu_torch.models import faceformer_vert as tffv
from avi_talking_tpu_torch.models.fan_encoder import FanEncoder
from avi_talking_tpu_torch.train import emo_cls as temo
from avi_talking_tpu_torch.train.faceformer_vert_trainer import (
    EmoClsPretrainer,
    FaceFormerVertTrainer,
)
from avi_talking_tpu_torch.train.optim import adam
from _torch_threads import one_torch_thread  # noqa: F401


B, T, LR = 2, 8, 1e-4


def _perturbed(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * scale).astype(np.float32), tree)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def tower_vars():
    """JAX's FAN (64^2) at its init with BatchNorm statistics moved off 0 / 1,
    and its head perturbed: initialised once for the module, jitted (the
    same values as flax's eager init, which takes half a minute)."""
    rng = np.random.default_rng(1)

    def stats(tree):
        return jax.tree.map(lambda a: (np.asarray(a) + 0.5 * rng.random(a.shape)).astype(
            np.float32), tree)

    fan_vars = jax.jit(JFan().init)(jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 3)))
    fan_vars = {"params": fan_vars["params"], "batch_stats": stats(fan_vars["batch_stats"])}
    head_vars = jax.jit(jemo.EmoClsHead().init)(jax.random.PRNGKey(6), jnp.zeros((1, 512)))
    head_vars = {"params": _perturbed(head_vars["params"], 2, 0.1),
                 "batch_stats": stats(head_vars["batch_stats"])}
    return fan_vars, head_vars


def _towers(tower_vars):
    """``tower_vars`` and the port's towers carrying them (new modules each
    call: a test may train the head)."""
    fan_vars, head_vars = tower_vars
    fan = FanEncoder(64).eval()
    fan.load_state_dict({k: torch.as_tensor(v)
                         for k, v in fan_encoder_state_from_jax(fan_vars).items()})
    head = temo.EmoClsHead().eval()
    head.load_state_dict({k: torch.as_tensor(v)
                          for k, v in emo_cls_head_state_from_jax(head_vars).items()})
    return fan_vars, head_vars, fan, head


def _mead_decoders():
    """The tiny command's FLAME (n_shape 8, n_exp 6) and non-trivial
    coefficient statistics: payload (B, T, 9) normalised -> vertices."""
    rng = np.random.default_rng(7)
    mean = (rng.standard_normal(59) * 0.1).astype(np.float32)
    std = (0.5 + rng.random(59)).astype(np.float32)
    jflame = JFlame(j_synthetic_assets(n_shape=8, n_exp=6), n_shape=8, n_exp=6)
    tassets = t_synthetic_assets(n_shape=8, n_exp=6)
    tflame = TFlame(tassets, n_shape=8, n_exp=6)

    def jverts(p):
        return jffv.convert_coeff2verts(jflame, p.reshape(-1, 9), jnp.asarray(mean),
                                        jnp.asarray(std)).reshape(p.shape[0], p.shape[1], -1)

    def tverts(p):
        return tffv.convert_coeff2verts(tflame, p.reshape(-1, 9), torch.from_numpy(mean),
                                        torch.from_numpy(std)).reshape(p.shape[0], p.shape[1], -1)

    return jflame, tassets, jverts, tverts


def _vert_template(jverts):
    return np.asarray(jverts(jnp.zeros((1, 1, 9))))[0, 0]


MODES = ["plain", "disentangle", "emo_cls"]


@pytest.mark.parametrize("mode", MODES)
def test_three_adam_steps_match_optax(mode, tower_vars):
    rng = np.random.default_rng(0)
    cfg = jffv.FaceFormerVertConfig.tiny()
    if mode == "emo_cls":  # the --mead-root source: coefficients decoded in the step
        jflame, tassets, jverts, tverts = _mead_decoders()
        template = _vert_template(jverts)
        payloads = [(rng.standard_normal((B, T, 9)) * 0.5).astype(np.float32) for _ in range(3)]
        one_hot = np.zeros((B, 1), np.float32)
    else:
        template = (rng.standard_normal(cfg.vertice_dim) * 0.01).astype(np.float32)
        payloads = [(rng.standard_normal((B, T, cfg.vertice_dim)) * 0.01).astype(np.float32)
                    for _ in range(3)]
        one_hot = np.eye(2, dtype=np.float32)[[1, 0]]

        def jverts(p):
            return p

        def tverts(p):
            return p
    cfg = jffv.FaceFormerVertConfig(vertice_dim=template.shape[0], feature_dim=32, period=5,
                                    num_train_subjects=one_hot.shape[1],
                                    wav2vec2=cfg.wav2vec2)
    audios = [rng.standard_normal((B, T * 640)).astype(np.float32) for _ in range(3)]
    emos = [rng.standard_normal((B, T, cfg.emo_dim)).astype(np.float32) for _ in range(3)]
    emo_idx = np.asarray([5, 1], np.int32)

    jm = jffv.FaceFormerVert(cfg, template=jnp.asarray(template))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), audios[0], jverts(payloads[0]), emos[0],
                              one_hot)
    params = {"params": _perturbed(params["params"], 3)}
    tcfg = tffv.FaceFormerVertConfig(vertice_dim=cfg.vertice_dim, feature_dim=32, period=5,
                                     num_train_subjects=cfg.num_train_subjects,
                                     wav2vec2=tffv.FaceFormerVertConfig.tiny().wav2vec2)
    tm = tffv.FaceFormerVert.random_init(tcfg, template=torch.from_numpy(template.copy()),
                                         device="cpu")
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in
                        faceformer_vert_state_from_jax(params["params"]).items()})

    V = cfg.vertice_dim // 3
    sel = jffv.FlameRegionSelector(frontal=np.ones(V, bool), mouth=np.arange(V) < V // 2,
                                   eye=np.arange(V) >= V // 2)
    jemo_loss = temo_loss = None
    if mode == "emo_cls":
        fan_vars, head_vars, fan, head = _towers(tower_vars)
        faces = np.array(jflame.assets.faces)
        jemo_loss = jemo.EmoClsLoss(faces=jnp.asarray(faces), fan=JFan(), fan_vars=fan_vars,
                                    head=jemo.EmoClsHead(), head_vars=head_vars,
                                    render_size=64, fan_size=64, stride=4)
        temo_loss = temo.EmoClsLoss(faces=tassets.faces, fan=fan, head=head, render_size=64,
                                    fan_size=64, stride=4)

    def jloss(p, audio, payload, emo, key):  # the JAX command's loss_fn
        verts = jverts(payload)
        if mode == "disentangle":
            terms = jffv.disentangle_losses(jm, p, audio, verts, emo, sel, key)
        else:
            pred = jm.apply(p, audio, verts, emo, one_hot)
            terms = {"verts": jnp.mean((pred - verts) ** 2)}
        if jemo_loss is not None:
            pred = jm.apply(p, audio, verts, emo, one_hot)
            terms["emo_cls"] = 0.1 * jemo_loss(pred, emo_idx)
        return sum(terms.values()), terms

    tx = optax.adam(LR)

    @jax.jit
    def jstep(p, opt, audio, payload, emo, key):
        (_, terms), g = jax.value_and_grad(jloss, has_aux=True)(p, audio, payload, emo, key)
        upd, opt = tx.update(g, opt)
        return optax.apply_updates(p, upd), opt, terms

    trainer = FaceFormerVertTrainer(
        model=tm, optimizer=adam(tm.parameters(), LR), to_verts=tverts,
        selector=tffv.FlameRegionSelector(sel.frontal, sel.mouth, sel.eye)
        if mode == "disentangle" else None, emo_cls=temo_loss)
    opt = tx.init(params)
    for i in range(3):
        key = jax.random.PRNGKey(i)
        r1, r2 = jax.random.split(key)
        perms = (np.asarray(jax.random.permutation(r1, B)),
                 np.asarray(jax.random.permutation(r2, B)))
        params, opt, jterms = jstep(params, opt, audios[i], payloads[i], emos[i], key)
        terms = trainer.train_step(*_t(audios[i], payloads[i], one_hot, emos[i], emo_idx),
                                   perms=tuple(_t(*perms)))
        assert set(terms) == set(jterms)
        for k in jterms:
            np.testing.assert_allclose(float(terms[k]), float(jterms[k]), atol=1e-4, rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    if mode == "emo_cls":  # a live tower: its features, and so the term's gradient, not all 0
        with torch.no_grad():
            imgs = temo_loss.images(tverts(torch.from_numpy(payloads[0])))
            assert float(temo_loss.fan.backbone_feature(imgs).abs().max()) > 0
    ref = faceformer_vert_state_from_jax(jax.tree.map(np.asarray, params["params"]))
    got = tm.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=1e-4, rtol=0, err_msg=k)


def test_three_pretrain_steps_match_optax(tower_vars):
    """The head alone, every frame rendered (stride 1), features without a
    gradient; its weights and BatchNorm statistics after three Adam steps,
    and the loss at each, < 1e-5 against JAX's pre_step."""
    jflame, tassets, jverts, tverts = _mead_decoders()
    fan_vars, head_vars, fan, head = _towers(tower_vars)
    rng = np.random.default_rng(4)
    Tp = 4
    payloads = [(rng.standard_normal((B, Tp, 9)) * 0.5).astype(np.float32) for _ in range(3)]
    labels = [np.asarray(x, np.int32) for x in ([5, 1], [0, -1], [7, 3])]
    jloss = jemo.EmoClsLoss(faces=jnp.asarray(np.array(jflame.assets.faces)), fan=JFan(),
                            fan_vars=fan_vars, head=jemo.EmoClsHead(), head_vars=head_vars,
                            render_size=64, fan_size=64, stride=1)
    tx = optax.adam(LR)

    @jax.jit
    def pre_step(hv, opt, payload, emo_idx):  # the JAX command's pre_step
        loss, g = jax.value_and_grad(
            lambda h: jloss(jverts(payload), emo_idx, head_vars=h))(hv)
        upd, opt = tx.update(g, opt)
        return optax.apply_updates(hv, upd), opt, loss, g

    tloss = temo.EmoClsLoss(faces=tassets.faces, fan=fan, head=head, render_size=64,
                            fan_size=64, stride=1)
    pre = EmoClsPretrainer(tloss, head, adam(temo.emo_cls_trainables(head), LR), tverts)
    hv, opt = head_vars, tx.init(head_vars)
    start = {k: v.clone() for k, v in head.state_dict().items()}
    for i in range(3):
        hv, opt, ref, g = pre_step(hv, opt, payloads[i], labels[i])
        assert float(np.abs(np.asarray(g["batch_stats"]["bn"]["mean"])).max()) > 0
        got = pre.train_step(*_t(payloads[i], labels[i]))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=1e-6, err_msg=str(i))
    ref_sd = emo_cls_head_state_from_jax(jax.tree.map(np.asarray, hv))
    got_sd = head.state_dict()
    for k, v in ref_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got_sd[k].numpy(), v, atol=1e-5, rtol=0, err_msg=k)
    moved = float((got_sd["2.running_var"] - start["2.running_var"]).abs().max())
    assert moved > 2e-4  # the statistics took three Adam steps
    assert not any(p.requires_grad for p in fan.parameters())


BASE = ["train-faceformer-vert", "--tiny", "--device", "cpu", "--batch-size", "2",
        "--frames", "8"]


def _write_wav(path, seconds, sr=16000):
    t = np.linspace(0, seconds, int(sr * seconds), endpoint=False)
    data = (np.sin(2 * np.pi * 220 * t) * 0.3 * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


@pytest.fixture(scope="module")
def mead_root(tmp_path_factory):
    """Six 20-frame MEAD clips (two identities x neutral / happy / angry)."""
    root = tmp_path_factory.mktemp("mead_vert")
    rng = np.random.default_rng(0)
    for ident in ("M003", "W009"):
        for emo, lvl in (("neutral", 1), ("happy", 2), ("angry", 3)):
            name = f"{ident}_front_{emo}_level{lvl}_001"
            for i in range(20):
                fd = root / name / "EMOCA_v2_lr_mse_20" / f"{i:06d}_000"
                fd.mkdir(parents=True)
                np.save(fd / "exp.npy", rng.standard_normal(50).astype(np.float32))
                np.save(fd / "pose.npy", rng.standard_normal(6).astype(np.float32) * 0.1)
                np.save(fd / "shape.npy", rng.standard_normal(100).astype(np.float32))
                np.save(fd / "cam.npy", rng.standard_normal(3).astype(np.float32))
            _write_wav(root / name / f"{name}.wav", 20 / 25)
    return str(root)


@pytest.fixture(scope="module")
def vocaset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vocaset_vert")
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


def _final(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("final:")]
    assert len(lines) == 1, out
    final = ast.literal_eval(lines[0][len("final:"):].strip())
    assert all(np.isfinite(v) for v in final.values()), final
    return final


@pytest.mark.parametrize("mode,terms", [
    ([], {"verts"}),
    (["--disentangle"], {"verts", "verts_eye_area", "verts_mouth_area"}),
    (["--mead-root", "M", "--emo-cls"], {"verts", "emo_cls"}),
    (["--mead-root", "M", "--disentangle", "--emo-cls"],
     {"verts", "verts_eye_area", "verts_mouth_area", "emo_cls"}),
])
def test_command_runs_in_every_mode(mead_root, capsys, mode, terms):
    mode = [mead_root if a == "M" else a for a in mode]
    assert cli_main(BASE + ["--steps", "2", *mode]) == 0
    out = capsys.readouterr()
    assert set(_final(out.out)) == terms
    if "--emo-cls" in mode:
        assert "RANDOM-init" in out.err


def test_command_on_a_vocaset_root(vocaset_root, capsys):
    assert cli_main(BASE + ["--steps", "2", "--root", vocaset_root]) == 0
    out = capsys.readouterr().out
    assert "autodetected subjects ['FaceTalk_A', 'FaceTalk_B']" in out
    assert set(_final(out)) == {"verts"}
    assert cli_main(BASE + ["--steps", "1", "--root", vocaset_root, "--disentangle",
                            "--train-subjects", "FaceTalk_B"]) == 0
    assert set(_final(capsys.readouterr().out)) == {"verts", "verts_eye_area",
                                                    "verts_mouth_area"}


def test_pretrain_then_head_checkpoint(mead_root, capsys, tmp_path):
    """The pretrain stage trains the head alone and saves it; ``--emo-cls
    --head-checkpoint`` then starts from it (JAX's
    ``test_cli_emo_cls_pretrain_roundtrip``)."""
    ck = str(tmp_path / "head")
    assert cli_main(BASE + ["--steps", "2", "--mead-root", mead_root, "--emo-cls-pretrain",
                            "--ckpt-dir", ck]) == 0
    assert set(_final(capsys.readouterr().out)) == {"emo_cls"}
    state = restore_checkpoint(ck)["emo_cls_head"]
    head = temo.EmoClsHead.random_init(seed=6, device="cpu")
    init = {k: v.clone() for k, v in head.state_dict().items()}
    head.load_state_dict(state)
    for k in ("0.weight", "2.running_mean", "2.running_var", "3.bias"):
        assert not torch.equal(state[k], init[k]), k  # trained, the statistics too
    assert cli_main(BASE + ["--steps", "1", "--mead-root", mead_root, "--emo-cls",
                            "--head-checkpoint", ck]) == 0
    assert set(_final(capsys.readouterr().out)) == {"verts", "emo_cls"}


def test_ckpt_dir_and_fan_checkpoint(mead_root, capsys, tmp_path):
    """``--ckpt-dir`` saves the model's state; ``--fan-checkpoint`` reads a
    reference-named FAN state dict (wrapped in "state_dict", as a Lightning
    checkpoint is) strictly: a missing key fails."""
    sd = FanEncoder.random_init(64, seed=1, device="cpu").state_dict()
    fan_ck = str(tmp_path / "fan.pt")
    torch.save({"state_dict": sd}, fan_ck)
    ck = str(tmp_path / "ck")
    assert cli_main(BASE + ["--steps", "1", "--mead-root", mead_root, "--emo-cls",
                            "--fan-checkpoint", fan_ck, "--ckpt-dir", ck]) == 0
    out = capsys.readouterr()
    assert "RANDOM-init" not in out.err
    params = restore_checkpoint(ck)["params"]
    assert "vertice_map.weight" in params and params["vertice_map.weight"].shape[1] == 128 * 3
    sd.pop("model.fc.bias")
    torch.save(sd, fan_ck)
    with pytest.raises(RuntimeError, match="model.fc.bias"):
        cli_main(BASE + ["--steps", "1", "--mead-root", mead_root, "--emo-cls",
                         "--fan-checkpoint", fan_ck])


def test_first_mead_batch_equals_the_jax_commands(mead_root):
    args = argparse.Namespace(mead_root=mead_root, tiny=True, flame_npz=None, batch_size=4,
                              frames=8, root=None)
    src = batch_source(args, np.random.default_rng(0), torch.device("cpu"))
    audio, coeff, one_hot, emo_idx = src.batch()
    # the JAX command's data path: its dataset, builder and iterator as it builds them
    ds = JMead(root=mead_root, seq_length=8)
    builder = JBuilder(ds, frames=8, coeff_dim=6 + 3, load_images=False)
    ref = next(j_batch_iterator(builder, batch_size=min(4, len(builder)), epochs=None))
    np.testing.assert_array_equal(audio.numpy(), ref["audio"])
    np.testing.assert_array_equal(coeff.numpy(), ref["coeff"])
    np.testing.assert_array_equal(emo_idx.numpy(), ref["emo_idx"])
    assert one_hot.shape == (4, 1) and not one_hot.any()
    assert src.vert_dim == 128 * 3 and tuple(src.to_verts(coeff).shape) == (4, 8, 384)


@pytest.mark.parametrize("flags,what", [
    (["--emo-cls"], "need --mead-root"),
    (["--emo-cls-pretrain"], "need --mead-root"),
    (["--bf16"], "float32"),
    (["--checkpoint", "ck"], "seeded random weights"),
])
def test_command_refuses(flags, what, capsys):
    """--emo-cls without MEAD labels is refused; --bf16 and --checkpoint,
    which the JAX command parses and never reads, are taken with a line on
    stderr that says so (and why), and the run ends."""
    if flags[0].startswith("--emo-cls"):
        with pytest.raises(SystemExit, match=what):
            cli_main(BASE + ["--steps", "1", *flags])
        return
    assert cli_main(BASE + ["--steps", "1", *flags]) == 0
    out, err = capsys.readouterr()
    assert f"{flags[0]} is ignored, as in the JAX command" in err and what in err
    assert len([line for line in out.splitlines() if line.startswith("final:")]) == 1


def test_command_needs_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = [a for a in BASE if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(run + ["--steps", "1"])
