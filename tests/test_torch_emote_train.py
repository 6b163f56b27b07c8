"""Port parity, the EMOTE training path: ``TalkingHeadTrainer`` steps from
weights carried by ``infra.jax_params`` against JAX's trainer with
``optax.adamw`` on the same batches (``golden_cases.emote_case``'s), the
golden per-step losses, the ``frame_mask`` / vertex path, the condition
exchange with JAX's permutation passed in, and the staged driver.

JAX hands the head's whole variables tree to optax, ``batch_stats``
included, and its gradient reaches FLINT's BatchNorm statistics through
``use_running_average``: the statistics train like weights. The port does
the same (``emote_trainables``), so they are held to JAX at 1e-4 like
every other weight."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avi_talking_tpu.core import assets as jassets
from avi_talking_tpu.models.emote import EmoteConfig as JConfig
from avi_talking_tpu.models.emote import EmoteTalkingHead as JHead
from avi_talking_tpu.models.conditioning import StyleCondition as JCond
from avi_talking_tpu.infra import run_dir as jrun_dir
from avi_talking_tpu.train import eval_metrics as jem
from avi_talking_tpu.train.eval_metrics import condition_exchange as j_exchange
from avi_talking_tpu.train.talking_head import TalkingHeadTrainer as JTrainer
from avi_talking_tpu_torch.core import assets as tassets
from avi_talking_tpu_torch.infra import run_dir as trun_dir
from avi_talking_tpu_torch.infra.checkpoint import restore_checkpoint
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.infra.jax_params import emote_head_state_from_jax
from avi_talking_tpu_torch.models.emote import EmoteConfig, EmoteTalkingHead
from avi_talking_tpu_torch.train.emote_driver import EmoteStage, train_emote
from avi_talking_tpu_torch.train import eval_metrics as tem
from avi_talking_tpu_torch.train.eval_metrics import condition_exchange, derangement
from avi_talking_tpu_torch.train.optim import adamw
from avi_talking_tpu_torch.train.talking_head import (
    NeuralLosses,
    TalkingHeadTrainer,
    emote_trainables,
)
from _torch_threads import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_train.json")
TOL = 1e-4


def _batch(cfg, B=2, seed=0):
    """``golden_cases.emote_case``'s batch (numpy)."""
    T = 2 * cfg.flint.latent_frame_size
    d = np.random.default_rng(seed)
    return {
        "raw_audio": d.standard_normal((B, T, 640)).astype(np.float32),
        "expression": np.eye(8, dtype=np.float32)[[1, 5]],
        "intensity": np.eye(3, dtype=np.float32)[[0, 2]],
        "identity": np.eye(32, dtype=np.float32)[[3, 9]],
        "shape": np.zeros((B, cfg.n_shape), np.float32),
        "gt_exp": d.standard_normal((B, T, cfg.flint.n_exp)).astype(np.float32) * 0.1,
        "gt_jaw": d.standard_normal((B, T, 3)).astype(np.float32) * 0.05,
    }


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _init(jcfg, batch, assets=None):
    """JAX head and its variables as ``emote_case`` builds them (PRNGKey 0)."""
    jm = JHead(jcfg, flame_assets=assets)
    cond = JCond(*(jnp.asarray(batch[k]) for k in ("expression", "intensity", "identity",
                                                   "shape")))
    return jm, jax.jit(lambda k, a: jm.init(k, a, cond))(jax.random.PRNGKey(0),
                                                         jnp.asarray(batch["raw_audio"]))


def _port(tcfg, variables, cond_dim, assets=None):
    tm = random_module(lambda: EmoteTalkingHead(tcfg, condition_dim=cond_dim),
                       torch.device("cpu"), torch.Generator().manual_seed(0))
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in emote_head_state_from_jax(variables).items()})
    tm.flame_assets = assets
    return tm


def _assert_state_matches(tm, variables, steps, lr):
    """Every weight and statistic < 1e-4, but the key biases of each
    attention (wav2vec2's k_proj biases, the middle third of each
    in_proj_bias): their exact gradient is 0 (softmax is shift invariant
    along a key row), so each AdamW step moves them by up to lr along the
    sign of rounding noise, and two right implementations differ by up to
    2 * lr a step (PR 3's rule for the card against the CPU)."""
    ref = emote_head_state_from_jax(jax.tree.map(np.asarray, variables))
    got = tm.state_dict()
    assert set(got) == set(ref)
    noisy = 2 * lr * steps + 1e-7
    for k, v in ref.items():
        g = got[k].numpy()
        if k.endswith("k_proj.bias"):
            np.testing.assert_allclose(g, v, atol=noisy, rtol=0, err_msg=k)
            continue
        if k.endswith("in_proj_bias"):
            d = v.shape[0] // 3
            np.testing.assert_allclose(g[d:2 * d], v[d:2 * d], atol=noisy, rtol=0, err_msg=k)
            g, v = np.concatenate([g[:d], g[2 * d:]]), np.concatenate([v[:d], v[2 * d:]])
        np.testing.assert_allclose(g, v, atol=TOL, rtol=0, err_msg=k)


def _run_both(jcfg, tcfg, batch, steps, lr=1e-4, disentangle=None, jassets_=None,
              tassets_=None):
    """``steps`` optimizer steps of both trainers on ``batch``; JAX's step i
    draws from PRNGKey(i), whose exchange permutation the port is given."""
    jm, variables = _init(jcfg, batch, jassets_)
    cond_dim = sum(batch[k].shape[-1] for k in ("expression", "intensity", "identity", "shape"))
    tm = _port(tcfg, variables, cond_dim, tassets_)
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    tx = optax.adamw(lr)
    jt = JTrainer(head=jm, tx=tx, disentangle=disentangle)
    step = jax.jit(jt.train_step)
    opt = tx.init(variables)
    trainer = TalkingHeadTrainer(head=tm, optimizer=adamw(emote_trainables(tm), lr),
                                 disentangle=disentangle)
    jb, tb = jax.tree.map(jnp.asarray, batch), _torch(batch)
    jms, tms = [], []
    for i in range(steps):
        rng = jax.random.PRNGKey(i)
        perm = None
        if disentangle:
            perm = torch.from_numpy(np.asarray(j_exchange(jb, rng)[1]).astype(np.int64))
        variables, opt, jmet = step(variables, opt, jb, rng)
        jms.append({k: float(v) for k, v in jmet.items()})
        tms.append({k: float(v) for k, v in trainer.train_step(tb, perm=perm).items()})
    return {"jax": jms, "port": tms, "tm": tm, "variables": variables, "start": start,
            "steps": steps, "lr": lr}


@pytest.fixture(scope="module")
def golden_run():
    """``emote_case``: tiny config, B=2, adamw(1e-4), three steps on both sides."""
    return _run_both(JConfig.tiny(), EmoteConfig.tiny(), _batch(JConfig.tiny()), steps=3)


def test_three_steps_losses_match_jax(golden_run):
    """Every metric (``loss``, ``loss_exp`` and the velocity and jaw terms)
    at each of three steps: < 1e-4."""
    for i, (jm, tm) in enumerate(zip(golden_run["jax"], golden_run["port"])):
        assert set(tm) == set(jm) == {"loss", "loss_exp", "loss_exp_vel", "loss_jaw",
                                      "loss_jaw_vel"}
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], atol=TOL, rtol=0, err_msg=f"step {i} {k}")


def test_three_steps_parameters_match_jax(golden_run):
    """Every weight and BatchNorm statistic after three steps (the rule of
    ``_assert_state_matches``); the steps moved the weights and the
    statistics."""
    tm = golden_run["tm"]
    _assert_state_matches(tm, golden_run["variables"], golden_run["steps"], golden_run["lr"])
    got, start = tm.state_dict(), golden_run["start"]
    moved = max(float((got[k] - start[k]).abs().max()) for k in start)
    stats_moved = max(float((got[k] - start[k]).abs().max()) for k in start
                      if k.endswith(("running_mean", "running_var")))
    assert moved > 2e-4 and stats_moved > 2e-4


def test_three_steps_match_golden(golden_run):
    """The golden ``emote`` entry (rtol 2e-3, atol 1e-5, as test_golden.py)."""
    with open(GOLDEN) as f:
        golden = json.load(f)["emote"]
    for key, want in golden.items():
        np.testing.assert_allclose([m[key] for m in golden_run["port"]], want, rtol=2e-3,
                                   atol=1e-5, err_msg=key)


def test_frame_mask_and_vertex_terms_match_jax():
    """Padded windows (frame_mask, so masked means, both-endpoint velocity
    masks and valid_len in wav2vec2) with FLAME vertices and a vertex term,
    and the audio encoder frozen (``audio_trainable=False``): two steps."""
    kw = dict(audio_trainable=False)
    jcfg = dataclasses.replace(JConfig.tiny(), **kw)
    tcfg = dataclasses.replace(EmoteConfig.tiny(), **kw)
    batch = _batch(jcfg, seed=3)
    B, T = batch["gt_exp"].shape[:2]
    mask = np.ones((B, T), np.float32)
    mask[1, 11:] = 0.0
    rng = np.random.default_rng(4)
    akw = dict(n_shape=8, n_exp=6)
    V = jassets.synthetic_assets(**akw).v_template.shape[0]
    batch.update(frame_mask=mask,
                 gt_vertices=rng.standard_normal((B, T, V, 3)).astype(np.float32) * 0.01)
    run = _run_both(jcfg, tcfg, batch, steps=2, jassets_=jassets.synthetic_assets(**akw),
                    tassets_=tassets.synthetic_assets(**akw))
    for i, (jm, tm) in enumerate(zip(run["jax"], run["port"])):
        assert set(tm) == set(jm) and "loss_vertex" in tm
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], atol=TOL, rtol=0, err_msg=f"step {i} {k}")
    _assert_state_matches(run["tm"], run["variables"], run["steps"], run["lr"])
    got = run["tm"].state_dict()
    frozen = [k for k in got if k.startswith("audio_encoder.")]
    assert frozen and all(torch.equal(got[k], run["start"][k]) for k in frozen)


def test_condition_exchange_stage_matches_jax():
    """The disentangled stage with JAX's permutations passed in: two steps,
    every metric and every weight < 1e-4."""
    run = _run_both(JConfig.tiny(), EmoteConfig.tiny(), _batch(JConfig.tiny(), seed=5), steps=2,
                    lr=5e-5, disentangle="condition_exchange")
    for i, (jm, tm) in enumerate(zip(run["jax"], run["port"])):
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], atol=TOL, rtol=0, err_msg=f"step {i} {k}")
    _assert_state_matches(run["tm"], run["variables"], run["steps"], run["lr"])


def test_condition_exchange_matches_jax():
    """The doubled batch for JAX's permutation is JAX's, bit for bit."""
    rng = np.random.default_rng(6)
    batch = {"expression": np.eye(8, dtype=np.float32)[rng.integers(0, 8, 5)],
             "intensity": np.eye(3, dtype=np.float32)[rng.integers(0, 3, 5)],
             "identity": np.eye(32, dtype=np.float32)[rng.integers(0, 32, 5)],
             "gt_exp": rng.standard_normal((5, 8, 6)).astype(np.float32)}
    jout, jperm = j_exchange(jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(11))
    perm = torch.from_numpy(np.asarray(jperm).astype(np.int64))
    out, got_perm = condition_exchange(_torch(batch), perm=perm)
    assert got_perm is perm and set(out) == set(jout)
    for k in batch:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]), err_msg=k)


@pytest.mark.parametrize("B", range(2, 10))
def test_port_exchange_draw_is_a_derangement(B):
    """The port's own draw (JAX's construction) is a permutation without a
    fixed point, for 50 seeds at each batch size."""
    for seed in range(50):
        perm = derangement(B, torch.Generator().manual_seed(seed))
        assert sorted(perm.tolist()) == list(range(B))
        assert bool((perm != torch.arange(B)).all()), (B, seed, perm)


def test_vertex_metrics_match_jax():
    """``vertex_l2`` and ``lip_vertex_error`` (max over the mouth's
    vertices, mean over frames) on (B, T, V, 3) vertices."""
    r = np.random.default_rng(8)
    pred, gt = (r.standard_normal((2, 5, 40, 3)).astype(np.float32) for _ in range(2))
    mouth = r.random(40) < 0.3
    tp_, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    jp_, jg = jnp.asarray(pred), jnp.asarray(gt)
    np.testing.assert_allclose(float(tem.vertex_l2(tp_, tg)), float(jem.vertex_l2(jp_, jg)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(tem.lip_vertex_error(tp_, tg, torch.from_numpy(mouth))),
        float(jem.lip_vertex_error(jp_, jg, jnp.asarray(mouth))), rtol=1e-6)


def test_run_dir_round_trip_matches_jax(tmp_path):
    """``create_run_dir`` names a fresh ``<stamp>_<id>_<experiment>``
    directory with ``checkpoints/`` and JAX's cfg.json byte for byte;
    ``load_config_snapshot`` reads it back; ``resume_from`` reuses the
    directory and backs the old snapshot up to cfg.json.bak."""
    cfg = {"stages": [EmoteStage("geometric", 3, 1e-4),
                      EmoteStage("disentangled", 3, 5e-5, disentangle="condition_exchange")],
           "lr": np.float32(1e-4), "frames": 64, "shape": (8, 64), "root": None}
    rd = trun_dir.create_run_dir(tmp_path / "runs", "emote", cfg)
    assert rd.parent == tmp_path / "runs" and rd.name.endswith("_emote")
    assert (rd / "checkpoints").is_dir()
    jrd = jrun_dir.create_run_dir(tmp_path / "jax", "emote", cfg)
    assert (rd / "cfg.json").read_text() == (jrd / "cfg.json").read_text()
    got = trun_dir.load_config_snapshot(rd)
    assert got == jrun_dir.load_config_snapshot(jrd)
    assert got["stages"][1]["disentangle"] == "condition_exchange" and got["shape"] == [8, 64]
    again = trun_dir.create_run_dir(tmp_path / "ignored", "x", {"frames": 32}, resume_from=rd)
    assert again == rd and not (tmp_path / "ignored").exists()
    assert trun_dir.load_config_snapshot(rd) == {"frames": 32}
    assert json.loads((rd / "cfg.json.bak").read_text()) == got


def test_neural_losses_wait_for_their_slice():
    """The neural stage's entry points take their arguments: a suite with
    no tower enabled adds nothing to the geometric metrics, and a
    ``use_neural`` stage given no suite trains the geometric loss (JAX:
    ``neural if stage.use_neural else None``). The suite itself is held to
    JAX in tests/test_torch_emote_neural.py."""
    cfg = EmoteConfig.tiny()
    tm = random_module(lambda: EmoteTalkingHead(cfg, condition_dim=51), torch.device("cpu"),
                       torch.Generator().manual_seed(0))
    suite = NeuralLosses(renderer=None)
    assert not suite.any_enabled()
    batch = _torch(_batch(cfg))
    trainer = TalkingHeadTrainer(head=tm, optimizer=adamw(tm.parameters(), 1e-4), neural=suite)
    assert set(trainer.eval_step(batch)) == {"loss", "loss_exp", "loss_exp_vel", "loss_jaw",
                                             "loss_jaw_vel"}
    res = train_emote(tm, lambda: iter([batch]),
                      stages=[EmoteStage("perceptual", 1, use_neural=True)], log_every=1000)
    assert res["total_steps"] == 1


@pytest.fixture(scope="module")
def driver_setup():
    cfg = EmoteConfig.tiny()
    batch = _torch(_batch(cfg))

    def head():
        return random_module(lambda: EmoteTalkingHead(cfg, condition_dim=51),
                             torch.device("cpu"), torch.Generator().manual_seed(1))

    return head, batch


def test_staged_training_with_run_dir(driver_setup, tmp_path):
    """Two stages (geometric, then condition exchange), validation every 3
    steps, best / last checkpoints that load back, the config snapshot and
    the scalar log."""
    make_head, batch = driver_setup
    head = make_head()
    stages = [EmoteStage(name="geometric", steps=6, lr=3e-3),
              EmoteStage(name="disentangled", steps=6, lr=1e-3,
                         disentangle="condition_exchange")]
    run = tmp_path / "run"
    res = train_emote(head, lambda: iter([batch] * 4), stages=stages,
                      val_batches=lambda: iter([batch]), val_every=3, run_dir=str(run),
                      log_every=100)
    assert res["total_steps"] == 12
    assert [len(res["histories"][s]) for s in ("geometric", "disentangled")] == [2, 2]
    g = res["histories"]["geometric"]
    assert g[-1]["loss"] < g[0]["loss"]  # the overfit batch improves
    losses = [h["loss"] for s in ("geometric", "disentangled") for h in res["histories"][s]]
    assert res["best_val"] == min(losses)
    assert (run / "cfg.json").exists()
    best = restore_checkpoint(str(run / "checkpoints" / "best"))
    last = restore_checkpoint(str(run / "checkpoints" / "last"))
    assert set(best) == set(last) == {"params", "step"} and last["step"] == 12
    assert best["step"] == [h["step"] for s in ("geometric", "disentangled")
                            for h in res["histories"][s]][losses.index(min(losses))]
    for k, v in head.state_dict().items():  # last holds the final weights
        torch.testing.assert_close(last["params"][k], v, atol=0, rtol=0)
    logged = [json.loads(line) for line in open(run / "logs" / "scalars.jsonl")]
    assert any("emote_val/disentangled/loss" in entry for entry in logged)


def test_early_stop_inside_stage(driver_setup):
    """lr 0: no validation improves on the first; patience 2 stops the
    stage at its third validation (step 6 of 50)."""
    make_head, batch = driver_setup
    res = train_emote(make_head(), lambda: iter([batch]), stages=[EmoteStage("frozen", 50, lr=0.0)],
                      val_batches=lambda: iter([batch]), val_every=2, early_stop_patience=2,
                      log_every=1000)
    assert res["total_steps"] == 6
