"""Port parity, the FaceFormer training step: three ``FaceFormerTrainer``
steps (AdamW set to ``optax.adamw``'s defaults, gradients through K1 and
K3's autograd backward) from carried weights on the same batches as the JAX
trainer with ``optax.adamw(1e-4)``; and the ``train-faceformer`` command on
the CPU."""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from avi_talking_tpu.models import faceformer as jff
from avi_talking_tpu.train.faceformer_trainer import FaceFormerTrainer as JTrainer
from avi_talking_tpu_torch.cli import main as cli_main
from avi_talking_tpu_torch.cli.train import synthetic_batches
from avi_talking_tpu_torch.core.assets import synthetic_assets as t_synthetic_assets
from avi_talking_tpu_torch.core.flame import FlameModel as TFlame
from avi_talking_tpu_torch.infra.checkpoint import restore_checkpoint
from avi_talking_tpu_torch.infra.jax_params import faceformer_state_from_jax
from avi_talking_tpu_torch.models import faceformer as tff
from avi_talking_tpu_torch.train.faceformer_trainer import FaceFormerTrainer
from avi_talking_tpu_torch.train.optim import adamw
from _torch_threads import one_torch_thread  # noqa: F401


def test_three_adamw_steps_match_optax():
    """Loss at each step and every parameter after three steps: < 1e-4."""
    cfg = jff.FaceFormerConfig.tiny()
    batches = synthetic_batches(tff.FaceFormerConfig.tiny(), 2, 8, seed=0, device="cpu")
    batches = [next(batches) for _ in range(3)]
    jb = [{k: v.numpy() for k, v in b.items()} for b in batches]

    jm = jff.FaceFormerCoeff(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jb[0]["audio"], jb[0]["coeff"],
                              jb[0]["eye_embed"], jb[0]["emo_embed"], jb[0]["ref_coeff"])
    rng = np.random.default_rng(1)  # perturb every leaf, so every gradient is non-zero
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.05).astype(np.float32), params)

    tm = tff.FaceFormerCoeff.random_init(tff.FaceFormerConfig.tiny(), device="cpu")
    tm.load_state_dict({k: torch.as_tensor(v)
                        for k, v in faceformer_state_from_jax(params["params"]).items()})
    trainer = FaceFormerTrainer(model=tm, optimizer=adamw(tm.parameters(), 1e-4))
    start = {k: v.clone() for k, v in tm.state_dict().items()}

    tx = optax.adamw(1e-4)
    jt = JTrainer(model=jm, tx=tx)
    step = jax.jit(jt.train_step)
    opt = tx.init(params)
    for i in range(3):
        params, opt, jmetrics = step(params, opt, jb[i], jax.random.PRNGKey(i))
        metrics = trainer.train_step(batches[i])
        assert set(metrics) == set(jmetrics) == {"coeff", "loss"}
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), atol=1e-4, rtol=0,
                                       err_msg=f"step {i} {k}")
    ref = faceformer_state_from_jax(jax.tree.map(np.asarray, params["params"]))
    got = tm.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=1e-4, rtol=0, err_msg=k)
    moved = max(float((got[k] - start[k]).abs().max()) for k in start)
    assert moved > 2e-4  # three steps of lr 1e-4 moved the weights


def test_trainer_refuses_terms_not_ported():
    """The render and emotion terms, once refused, are taken: their values
    join the metrics at weights 0.015 / 0.15 (their parity with JAX is held
    in ``test_torch_render_loss.py``)."""
    tm = tff.FaceFormerCoeff.random_init(tff.FaceFormerConfig.tiny(), device="cpu")
    batch = next(synthetic_batches(tff.FaceFormerConfig.tiny(), 2, 8, seed=0, device="cpu"))
    for kw, key in (({"render_loss_fn": lambda p, b: p.abs().mean()}, "render"),
                    ({"emo_loss_fn": lambda p, b: p.abs().mean()}, "emo")):
        trainer = FaceFormerTrainer(model=tm, optimizer=adamw(tm.parameters(), 1e-4), **kw)
        loss, metrics = trainer.loss_fn(batch)
        weight = 0.015 if key == "render" else 0.15
        assert set(metrics) == {"coeff", key, "loss"}
        np.testing.assert_allclose(float(loss), float(metrics["coeff"] + weight * metrics[key]),
                                   rtol=1e-6)


def test_trainer_takes_the_landmark_terms():
    """``flame=`` (once refused) adds the landmark terms; their parity with
    JAX is held in ``test_torch_flame_landmarks.py``."""
    tm = tff.FaceFormerCoeff.random_init(tff.FaceFormerConfig.tiny(), device="cpu")
    flame = TFlame(t_synthetic_assets(n_shape=8, n_exp=6, n_static_landmarks=51), 8, 6)
    trainer = FaceFormerTrainer(model=tm, optimizer=adamw(tm.parameters(), 1e-4), flame=flame)
    metrics = trainer.train_step(next(synthetic_batches(tff.FaceFormerConfig.tiny(), 2, 8, seed=0,
                                                        device="cpu")))
    assert set(metrics) == {"coeff", "ldmk", "loss"} and float(metrics["ldmk"]) > 0


def test_adamw_is_optax_default():
    opt = adamw([torch.nn.Parameter(torch.zeros(2))], 3e-4)
    (group,) = opt.param_groups
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        3e-4, (0.9, 0.999), 1e-8, 1e-4)


def test_cli_train_faceformer_runs_on_cpu(capsys):
    assert cli_main(["train-faceformer", "--tiny", "--device", "cpu", "--steps", "2",
                     "--batch-size", "2", "--seq-length", "8"]) == 0
    final = [line for line in capsys.readouterr().out.splitlines() if line.startswith("final:")]
    assert len(final) == 1 and "'loss'" in final[0] and "'coeff'" in final[0]
    assert np.isfinite(float(final[0].split("'loss': ")[1].rstrip("}")))


# --root and --fan-checkpoint are ported, and since the render slice the render
# flags: --root --render-loss runs (on a tree this test writes in place of the
# "/data" placeholder), and without --root --render-loss, --emo-loss and
# --emonet-checkpoint are ignored with a note, as JAX ignores them. --bf16 and
# --checkpoint, which the JAX command parses and never reads, are taken too,
# with a line on stderr, beside the others as alone.
@pytest.mark.parametrize("flag", [["--root", "/data", "--render-loss"], ["--render-loss"],
                                  ["--emo-loss"], ["--fan-checkpoint", "f.pt", "--bf16"],
                                  ["--emonet-checkpoint", "e.pt"], ["--bf16"],
                                  ["--checkpoint", "ck"]])
def test_cli_train_faceformer_refuses_what_is_not_ported(flag, tmp_path, capsys):
    args = ["train-faceformer", "--tiny", "--device", "cpu", "--steps", "1"]
    if "--root" in flag:
        from test_torch_train_data import CLIPS, _write_clip

        rng = np.random.default_rng(0)
        for name in CLIPS[:2]:
            _write_clip(tmp_path, name, rng, "EMOCA_v2_lr_mse_20/processed_x/detections")
        flag = ["--root", str(tmp_path), *flag[2:]]
    assert cli_main([*args, "--batch-size", "1", "--seq-length", "4", *flag]) == 0
    out, err = capsys.readouterr()
    final = [line for line in out.splitlines() if line.startswith("final:")]
    assert len(final) == 1
    if "--root" in flag:
        assert "'render'" in final[0] and "RANDOM-init PIRender" in err
    else:
        assert "'render'" not in final[0] and "ignored" in err
    for name in ("--bf16", "--checkpoint"):
        assert (f"{name} is ignored, as in the JAX command" in err) == (name in flag)


def test_cli_train_faceformer_ckpt_dir_saves_the_weights(tmp_path, capsys):
    """``--ckpt-dir`` (once refused) writes ``{"params": state_dict}``."""
    ck = str(tmp_path / "ck")
    assert cli_main(["train-faceformer", "--tiny", "--device", "cpu", "--steps", "1",
                     "--batch-size", "2", "--seq-length", "8", "--ckpt-dir", ck]) == 0
    state = restore_checkpoint(ck)["params"]
    tm = tff.FaceFormerCoeff.random_init(tff.FaceFormerConfig.tiny(), device="cpu")
    tm.load_state_dict(state)
    fresh = tff.FaceFormerCoeff.random_init(tff.FaceFormerConfig.tiny(), device="cpu")
    assert any(not torch.equal(v, fresh.state_dict()[k]) for k, v in state.items())


def test_cli_train_faceformer_flame_npz_adds_the_landmark_terms(tmp_path, capsys):
    """``--flame-npz`` (once refused) gives the landmark terms at full size,
    and, as in the JAX command, none with ``--tiny``."""
    assets = t_synthetic_assets(num_vertices=200, n_shape=100, n_exp=50, num_faces=150,
                                n_static_landmarks=51)
    npz = str(tmp_path / "flame.npz")
    np.savez(npz, **{f.name: getattr(assets, f.name).numpy()
                     for f in dataclasses.fields(assets)})
    run = ["train-faceformer", "--device", "cpu", "--steps", "1", "--batch-size", "1",
           "--seq-length", "4", "--flame-npz", npz]
    assert cli_main(run) == 0
    assert "'ldmk'" in capsys.readouterr().out
    assert cli_main(run + ["--tiny"]) == 0
    assert "'ldmk'" not in capsys.readouterr().out
