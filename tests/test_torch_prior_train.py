"""Port parity, the diffusion-prior training path at ``golden_cases.
prior_case``'s sizes: the losses of train/losses.py, the one-cycle
schedule, the global-norm clip and the decay groups against optax, three
``PriorTrainer`` steps against JAX's with JAX's random draws passed in
(the brain's dropout masks captured from flax, the timesteps, the noise
and the condition keep masks rebuilt from the step's key), the golden
``prior`` losses, and the ``train_prior`` loop (validation, best / last,
resume, early stop) on the CPU."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from avi_talking_tpu.models.brain import BrainNetwork as JBrain
from avi_talking_tpu.models.diffusion import DiffusionPrior as JPrior
from avi_talking_tpu.models.diffusion import NoiseScheduler as JSched
from avi_talking_tpu.models.prior_transformer import PriorTransformerNetwork as JNet
from avi_talking_tpu.train import eval_metrics as jem
from avi_talking_tpu.train import losses as jl
from avi_talking_tpu.train import prior as jp
from avi_talking_tpu_torch.infra.checkpoint import restore_checkpoint
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.infra.jax_params import prior_trainer_state_from_jax
from avi_talking_tpu_torch.models.brain import BrainNetwork
from avi_talking_tpu_torch.models.diffusion import DiffusionPrior, NoiseScheduler
from avi_talking_tpu_torch.models.prior_transformer import PriorTransformerNetwork
from avi_talking_tpu_torch.train import eval_metrics as tem
from avi_talking_tpu_torch.train import losses as tl
from avi_talking_tpu_torch.train import prior as tp
from avi_talking_tpu_torch.train.driver import PriorTrainingConfig, synthetic_batches, train_prior
from avi_talking_tpu_torch.train.optim import adamw

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_train.json")
DIM, IN, B, T_STEPS = 32, 48, 4, 10


def _rng(seed):
    return np.random.default_rng(seed)


# --- train/losses.py ------------------------------------------------------

def test_soft_clip_loss_matches_jax():
    r = _rng(0)
    p, t = (r.standard_normal((6, 16)).astype(np.float32) for _ in range(2))
    p, t = p / np.linalg.norm(p, axis=-1, keepdims=True), t / np.linalg.norm(t, axis=-1, keepdims=True)
    for temp in (0.125, 0.006):
        np.testing.assert_allclose(
            float(tl.soft_clip_loss(torch.from_numpy(p), torch.from_numpy(t), temp)),
            float(jl.soft_clip_loss(jnp.asarray(p), jnp.asarray(t), temp)), rtol=1e-5)


def test_cosine_anneal_matches_jax():
    for steps in (2, 7, 1000):
        np.testing.assert_allclose(tl.cosine_anneal(0.004, 0.0075, steps).numpy(),
                                   np.asarray(jl.cosine_anneal(0.004, 0.0075, steps)),
                                   rtol=1e-6, atol=0)


def test_batchwise_cosine_similarity_matches_jax():
    r = _rng(1)
    z, b = r.standard_normal((5, 12)).astype(np.float32), r.standard_normal((7, 12)).astype(np.float32)
    got = tl.batchwise_cosine_similarity(torch.from_numpy(z), torch.from_numpy(b)).numpy()
    ref = np.asarray(jl.batchwise_cosine_similarity(jnp.asarray(z), jnp.asarray(b)))
    assert got.shape == ref.shape == (7, 5)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("k", [1, 3, 5, 9])
def test_topk_accuracy_matches_jax(k):
    r = _rng(2)
    sims = r.standard_normal((8, 8)).astype(np.float32)
    sims[np.arange(8), np.arange(8)] += np.where(r.random(8) < 0.5, 3.0, 0.0).astype(np.float32)
    labels = np.arange(8)
    assert float(tl.topk_accuracy(torch.from_numpy(sims), torch.from_numpy(labels), k)) == \
        pytest.approx(float(jl.topk_accuracy(jnp.asarray(sims), jnp.asarray(labels), k)), abs=1e-6)


@pytest.mark.parametrize("n", [1, 2, 7])
def test_style_diversity_matches_jax(n):
    """Mean pairwise distance of n sampled style embeddings (0 for one)."""
    e = _rng(4).standard_normal((n, 128)).astype(np.float32)
    np.testing.assert_allclose(float(tem.style_diversity(torch.from_numpy(e))),
                               float(jem.style_diversity(jnp.asarray(e))), rtol=1e-6, atol=1e-6)


# --- optimizer ------------------------------------------------------------

@pytest.mark.parametrize("total", [1, 2, 3, 10, 1000])
def test_one_cycle_schedule_matches_optax(total):
    """Every count from 0 to total + 2: optax's schedule evaluated in
    float64, < 1e-7 relative. The port keeps the learning rate in float64
    as torch does; optax's own float32 evaluation under jit (int32 count)
    is off the exact values by up to 2.1e-4 of the value (total 1000, where
    the cosine cancels near a phase's end and the values reach 4e-10), and
    is held to 3e-4."""
    ref_sched = jp.one_cycle_schedule(1e-4, total)
    sched = tp.one_cycle_schedule(1e-4, total)
    counts = np.arange(total + 3)
    got = np.asarray([sched(int(c)) for c in counts])
    with jax.enable_x64(True):
        ref64 = np.asarray([float(ref_sched(jnp.asarray(c, jnp.int64))) for c in counts])
    np.testing.assert_allclose(got, ref64, rtol=1e-7, atol=0)
    ref32 = np.asarray(jax.jit(jax.vmap(lambda c: jnp.asarray(ref_sched(c), jnp.float32)))(
        counts.astype(np.int32)))
    np.testing.assert_allclose(got, ref32, rtol=3e-4, atol=0)


@pytest.mark.parametrize("scale", [0.05, 10.0])
def test_global_norm_clip_matches_optax(scale):
    """Below the limit the gradients pass unchanged; above it they scale to
    norm 1 exactly as optax does (no epsilon)."""
    r = _rng(3)
    grads = [(r.standard_normal(s) * scale).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    ref, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    tg = [torch.from_numpy(g.copy()) for g in grads]
    norm = tp.clip_by_global_norm_(tg, 1.0)
    assert float(norm) == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
    for g, want in zip(tg, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_global_norm_clip_sums_in_float64():
    """At the full-width brain's sizes (4096 x 4096 and 128 x 4096) the
    norm is the float64 norm of the float32 gradients to 1e-6, and the
    clipped gradients have norm 1 to 1e-6."""
    g = torch.Generator().manual_seed(0)
    grads = [torch.randn((4096, 4096), generator=g) * 1e-2, torch.randn((128, 4096), generator=g)]
    exact = float(torch.stack([x.double().norm() for x in grads]).norm())
    assert float(tp.clip_by_global_norm_(grads, 1.0)) == pytest.approx(exact, rel=1e-6)
    assert float(torch.stack([x.double().norm() for x in grads]).norm()) == pytest.approx(1.0, rel=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_setup():
    """``prior_case``'s modules and initial params."""
    brain = JBrain(out_dim=DIM, in_dim=IN, clip_size=DIM, hidden=64, n_blocks=2)
    net = JNet(dim=DIM, depth=2, heads=4, dim_head=8)
    rng = jax.random.PRNGKey(0)
    params = {"brain": jax.jit(brain.init)(rng, jnp.zeros((2, IN))),
              "prior": jax.jit(net.init)(rng, jnp.zeros((2, 1, DIM)), jnp.zeros((2,), jnp.int32),
                                         jnp.zeros((2, DIM)))}
    return brain, net, params


def _port_modules(params):
    g = torch.Generator().manual_seed(0)
    brain = random_module(lambda: BrainNetwork(out_dim=DIM, in_dim=IN, clip_size=DIM, hidden=64,
                                               n_blocks=2), torch.device("cpu"), g)
    net = random_module(lambda: PriorTransformerNetwork(dim=DIM, depth=2, heads=4, dim_head=8),
                        torch.device("cpu"), g)
    states = prior_trainer_state_from_jax(jax.tree.map(np.asarray, params))
    for mod, key in ((brain, "brain"), (net, "prior")):
        mod.load_state_dict({k: torch.as_tensor(v) for k, v in states[key].items()})
    return brain, DiffusionPrior(net=net, scheduler=NoiseScheduler.create(T_STEPS))


def test_decay_groups_match_no_decay_mask():
    """The port's two groups, leaf by leaf through the jax_params name map,
    are JAX's ``_no_decay_mask``."""
    _, _, params = _jax_setup()
    brain, prior = _port_modules(params)
    mask = prior_trainer_state_from_jax(jp._no_decay_mask(params))
    decay, no_decay = tp.decay_groups([brain, prior.net])
    ids = {id(p): True for p in decay} | {id(p): False for p in no_decay}
    named = {**{("brain", k): p for k, p in brain.named_parameters()},
             **{("prior", k): p for k, p in prior.net.named_parameters()}}
    assert len(ids) == len(named)
    for (part, k), p in named.items():
        assert ids[id(p)] == bool(mask[part][k]), (part, k)
    assert any(bool(v) for v in mask["prior"].values()) and not all(
        bool(v) for v in mask["brain"].values())


# --- the training step ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dropout_masks(brain):
    """flax's Dropout outputs in ``brain``'s train-mode apply, kept where
    non-zero: jitted once a brain (an eager apply takes seconds a step)."""
    @jax.jit
    def masks(p, x, key):
        out = []

        def capture(next_fun, args, kwargs, context):
            y = next_fun(*args, **kwargs)
            if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
                out.append(y != 0)
            return y

        with nn.intercept_methods(capture):
            brain.apply(p, x, deterministic=False, rngs={"dropout": key})
        return out

    return masks


def _jax_draws(brain, prior, params, voxel, rng):
    """The draws of JAX's ``PriorTrainer.loss_fn`` for the step key ``rng``:
    the brain's dropout masks (captured around flax's Dropout, kept where
    its output is non-zero) and the prior's times, noise and keep masks
    (the split / fold_in chain of ``DiffusionPrior.loss`` -> ``p_losses``
    -> the network's condition dropout)."""
    masks = [np.asarray(m) for m in _dropout_masks(brain)(
        params["brain"], jnp.asarray(voxel), jax.random.fold_in(rng, 1))]
    rng_t, rng_l = jax.random.split(jax.random.fold_in(rng, 2))
    times = jax.random.randint(rng_t, (voxel.shape[0],), 0, prior.scheduler.num_timesteps)
    rng_noise, rng_keep = jax.random.split(rng_l)
    noise = jax.random.normal(rng_noise, (voxel.shape[0], 1, DIM), jnp.float32)
    rb, ri = jax.random.split(rng_keep)
    keep = [np.array(jax.random.uniform(k, (voxel.shape[0], 1, 1)) >= 0.2) for k in (rb, ri)]
    assert len(masks) == 3 and not masks[0].all()
    return {"dropout": [torch.from_numpy(m) for m in masks],
            "times": torch.from_numpy(np.asarray(times).astype(np.int64)),
            "noise": torch.from_numpy(np.array(noise)),
            "brain_keep": torch.from_numpy(keep[0]), "image_keep": torch.from_numpy(keep[1])}


@pytest.mark.parametrize("clamp", [False, True])
def test_p_losses_matches_jax(clamp):
    """``DiffusionPrior.p_losses`` on carried weights with JAX's noise and
    condition keep masks rebuilt from its key, with and without
    ``training_clamp_l2norm`` (the prediction put back on the sphere of
    radius sqrt(dim)): loss within 1e-5 relative, prediction within 1e-5."""
    _, net, params = _jax_setup()
    jprior = JPrior(net=net, scheduler=JSched.create(T_STEPS), training_clamp_l2norm=clamp)
    _, tprior = _port_modules(params)
    tprior = dataclasses.replace(tprior, training_clamp_l2norm=clamp)
    r = _rng(5)
    x = (r.standard_normal((B, 1, DIM)) * np.sqrt(DIM)).astype(np.float32)
    text = r.standard_normal((B, DIM)).astype(np.float32)
    times = np.array([0, 3, T_STEPS - 1, 5], np.int32)
    rng = jax.random.PRNGKey(0)  # drops the brain condition of one row, the image's of two
    jloss, jpred = jprior.p_losses(params["prior"], jnp.asarray(x), jnp.asarray(times),
                                   jnp.asarray(text), rng)
    rng_noise, rng_keep = jax.random.split(rng)
    noise = np.array(jax.random.normal(rng_noise, x.shape, jnp.float32))
    keep = [torch.from_numpy(np.array(jax.random.uniform(k, (B, 1, 1)) >= 0.2))
            for k in jax.random.split(rng_keep)]
    assert [int(k.sum()) for k in keep] == [3, 2]
    tloss, tpred = tprior.p_losses(torch.from_numpy(x), torch.from_numpy(times.astype(np.int64)),
                                   torch.from_numpy(text), torch.from_numpy(noise), *keep)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5, atol=0)
    np.testing.assert_allclose(tpred.detach().numpy(), np.asarray(jpred), atol=1e-5, rtol=0)
    if clamp:
        np.testing.assert_allclose(tpred.detach().norm(dim=-1).numpy(), np.sqrt(DIM), rtol=1e-5)


def _run_steps(tx_jax, make_port_optimizer, steps=3):
    brain, net, params = _jax_setup()
    prior = JPrior(net=net, scheduler=JSched.create(T_STEPS))
    jtr = jp.PriorTrainer(brain=brain, prior=prior, tx=tx_jax(params))
    state = jp.PriorTrainState.create(params, jtr.tx)
    step = jtr.jitted_train_step(donate=False)
    tbrain, tprior = _port_modules(params)
    tstate = tp.PriorTrainState(tbrain, tprior, make_port_optimizer(tbrain, tprior))
    trainer = tp.PriorTrainer()
    d = np.random.default_rng(1)
    voxel = d.standard_normal((B, IN)).astype(np.float32)
    target = d.standard_normal((B, DIM)).astype(np.float32)
    jms, tms = [], []
    for i in range(steps):
        rng = jax.random.PRNGKey(i)
        draws = _jax_draws(brain, prior, state.params, voxel, rng)
        state, m = step(state, jnp.asarray(voxel), jnp.asarray(target), rng)
        jms.append({k: float(v) for k, v in m.items()})
        tms.append({k: float(v) for k, v in trainer.train_step(
            tstate, torch.from_numpy(voxel), torch.from_numpy(target), draws=draws).items()})
    assert tstate.step == steps
    return jms, tms, tstate, state


def _assert_metrics(jms, tms):
    for i, (jm, tm) in enumerate(zip(jms, tms)):
        assert set(tm) == set(jm) == {"loss", "loss_nce", "loss_prior", "cosine_sim",
                                      "top1_fwd", "top1_bwd"}
        for k in ("loss", "loss_nce", "loss_prior"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=0, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(tm["cosine_sim"], jm["cosine_sim"], atol=1e-5, rtol=0)
        assert (tm["top1_fwd"], tm["top1_bwd"]) == (jm["top1_fwd"], jm["top1_bwd"]), i


def test_three_steps_with_prior_optimizer_match_jax():
    """``make_prior_optimizer`` on both sides (clip at 1.0, one-cycle over
    10 steps, AdamW decay 1e-2 on the decay group): the losses at each step
    within 1e-4 relative, cosine similarity 1e-5, top-1 exactly, and every
    weight after three steps within 1e-5."""
    jms, tms, tstate, state = _run_steps(
        lambda params: jp.make_prior_optimizer(params, 1e-4, T_STEPS)[0],
        lambda brain, prior: tp.make_prior_optimizer(brain, prior, 1e-4, T_STEPS)[0])
    _assert_metrics(jms, tms)
    ref = prior_trainer_state_from_jax(jax.tree.map(np.asarray, state.params))
    for part, mod in (("brain", tstate.brain), ("prior", tstate.prior.net)):
        for k, v in mod.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[part][k], atol=1e-5, rtol=0,
                                       err_msg=f"{part}.{k}")


def test_three_steps_match_golden_and_jax():
    """``prior_case`` itself (``optax.adamw(1e-3)``, PRNGKey(i) per step):
    JAX within 1e-4 relative, and the golden ``prior`` entry (rtol 2e-3,
    atol 1e-5, as test_golden.py)."""
    jms, tms, _, _ = _run_steps(
        lambda params: optax.adamw(1e-3),
        lambda brain, prior: tp.PriorOptimizer(
            adamw(list(brain.parameters()) + list(prior.net.parameters()), 1e-3),
            lambda count: 1e-3))
    _assert_metrics(jms, tms)
    with open(GOLDEN) as f:
        golden = json.load(f)["prior"]
    for key, want in golden.items():
        np.testing.assert_allclose([m[key] for m in tms], want, rtol=2e-3, atol=1e-5, err_msg=key)


def test_condition_dropout_draws_from_a_generator():
    """Without explicit draws the step takes every draw from the generator:
    one seed, one loss; the keep masks drop about p of the rows."""
    _, _, params = _jax_setup()
    brain, prior = _port_modules(params)
    state = tp.PriorTrainState(brain, prior, tp.make_prior_optimizer(brain, prior)[0])
    d = np.random.default_rng(1)
    voxel = torch.from_numpy(d.standard_normal((B, IN)).astype(np.float32))
    target = torch.from_numpy(d.standard_normal((B, DIM)).astype(np.float32))
    losses = [float(tp.PriorTrainer().eval_step(state, voxel, target,
                                                generator=torch.Generator().manual_seed(s))["loss"])
              for s in (5, 5, 6)]
    assert losses[0] == losses[1] != losses[2]
    keep = prior.net(torch.zeros(4000, 1, DIM), torch.zeros(4000, dtype=torch.int32),
                     torch.zeros(4000, DIM), brain_cond_drop_prob=0.2, image_cond_drop_prob=0.2,
                     generator=torch.Generator().manual_seed(0))
    assert keep.shape == (4000, 1, DIM)
    with pytest.raises(ValueError, match="generator"):
        tp.PriorTrainer().loss_fn(state, voxel, target)


# --- the loop -------------------------------------------------------------

def tiny_cfg(**kw):
    base = dict(clip_size=16, in_dim=24, depth=1, heads=2, dim_head=8, timesteps=5,
                brain_hidden=32, total_steps=40, batch_size=8, log_every=100, val_every=10,
                val_steps=2)
    base.update(kw)
    return PriorTrainingConfig(**base)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("prior_val")
    res = train_prior(tiny_cfg(), logdir=str(root / "log"), ckpt_dir=str(root / "ck"),
                      device="cpu")
    return root, res


def test_val_loop_metrics_and_tags(run):
    root, res = run
    assert [v["step"] for v in res["val_history"]] == [10, 20, 30, 40]
    for v in res["val_history"]:
        for k in ("loss", "loss_nce", "loss_prior", "top1_fwd", "top1_bwd", "cosine_sim"):
            assert k in v and np.isfinite(v[k]), (k, v)
    assert (root / "ck" / "best").is_dir() and (root / "ck" / "last").is_dir()
    losses = [v["loss"] for v in res["val_history"]]
    assert res["best_val_loss"] == min(losses)
    lines = [json.loads(line) for line in open(root / "log" / "scalars.jsonl")]
    assert any(k.startswith("prior_val/") for line in lines for k in line)


def test_best_ckpt_is_the_best_validation(run):
    root, res = run
    best = restore_checkpoint(str(root / "ck" / "best"))
    assert set(best) == {"params", "step"} and set(best["params"]) == {"brain", "prior"}
    losses = [v["loss"] for v in res["val_history"]]
    assert best["step"] == res["val_history"][losses.index(min(losses))]["step"]
    last = restore_checkpoint(str(root / "ck" / "last"))
    assert set(last) == {"state", "best_val_loss"} and last["state"]["step"] == 40
    assert last["best_val_loss"] == res["best_val_loss"]


def test_resume_from_last(run):
    root, res1 = run
    cfg = tiny_cfg(resume=True)
    more = synthetic_batches(cfg.batch_size, 10, cfg.in_dim, cfg.clip_size, seed=7)
    res2 = train_prior(cfg, batches=more, ckpt_dir=str(root / "ck"), device="cpu")
    assert res2["state"].step == 50  # continued, not restarted
    assert res2["val_history"][0]["step"] == 50
    assert res2["best_val_loss"] <= res1["best_val_loss"]


def test_no_val_keeps_the_plain_layout(tmp_path):
    res = train_prior(tiny_cfg(val_every=0, total_steps=3), ckpt_dir=str(tmp_path / "ck"),
                      device="cpu")
    assert res["val_history"] == []
    assert set(restore_checkpoint(str(tmp_path / "ck"))) == {"params", "step"}


def test_early_stop_and_run_dir(tmp_path):
    """A constant validation stream cannot improve twice in a row: patience
    1 stops long before 200 steps; the run directory holds the snapshot,
    the logs and the checkpoints."""
    def constant_val():
        rng = np.random.default_rng(0)
        for _ in range(2):
            yield {"voxel": np.zeros((4, 24), np.float32),
                   "style_target": rng.standard_normal((4, 16)).astype(np.float32)}

    cfg = tiny_cfg(total_steps=200, batch_size=4, log_every=1000, val_every=5,
                   early_stop_patience=1)
    rd = tmp_path / "run"
    res = train_prior(cfg, run_dir=str(rd), val_batches=constant_val, device="cpu")
    assert res["state"].step < 200
    assert (rd / "cfg.json").exists() and (rd / "logs" / "scalars.jsonl").exists()
    assert (rd / "checkpoints" / "last").is_dir()
