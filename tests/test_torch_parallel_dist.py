"""Port parity, the parallel layer across processes: one 4-process gloo run
(dp 2 x tp 2) of the port's ``dryrun_multichip``, whose four cases each
hold the sharded step to the port's unsharded one (losses within 1e-5
relative, every gradient within 1e-5 of the largest, weights by the 2·lr
rule), and cases 1, 2 and 4 against JAX's replicated results on the same
weights, batches and draws, computed once in a module-scoped fixture at the
tolerance of each piece's own parity test (the EMOTE step 1e-4, the prior
step 1e-4 on the losses and 1e-5 on the weights, serving 1e-4; JAX's dry
run holds them at 1e-3, 5e-3 and 2e-4). Case 3's unsharded step is held to
JAX by ``test_torch_emote_neural.py``."""

import concurrent.futures

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_emote_train import _assert_state_matches
from test_torch_pipeline import _ddpm_noise
from avi_talking_tpu.core import assets as jassets
from avi_talking_tpu.models.brain import BrainNetwork as JBrain
from avi_talking_tpu.models.clip_text import ClipTextModel
from avi_talking_tpu.models.conditioning import StyleCondition as JCond
from avi_talking_tpu.models.diffusion import DiffusionPrior as JPrior
from avi_talking_tpu.models.diffusion import NoiseScheduler as JSched
from avi_talking_tpu.models.emote import EmoteConfig as JConfig
from avi_talking_tpu.models.emote import EmoteTalkingHead as JHead
from avi_talking_tpu.models.prior_transformer import PriorTransformerNetwork as JNet
from avi_talking_tpu.pipeline import generate as jgen
from avi_talking_tpu.train import prior as jprior
from avi_talking_tpu.train.talking_head import TalkingHeadTrainer as JTrainer
from avi_talking_tpu_torch.infra.jax_params import (
    emote_head_state_from_jax,
    pipeline_state_from_jax,
    prior_trainer_state_from_jax,
)
from avi_talking_tpu_torch.parallel import dryrun
from avi_talking_tpu_torch.pipeline import generate as tgen

LR = 1e-4
N = 4  # dp 2 x tp 2
B = 4  # two rows a dp rank, as the dry run's batches


def _random_like(init, seed):
    """Seeded weights of the shapes ``init`` gives (traced, not compiled):
    kernels and embeddings N(0, 1 / fan_in), norm scales and gains about 1,
    biases and statistics' means about 0, variances in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        key = path[-1].key
        if key == "var":
            a = 0.5 + rng.random(leaf.shape)
        elif key in ("scale", "g"):
            a = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif key in ("bias", "mean"):
            a = 0.1 * rng.standard_normal(leaf.shape)
        else:
            a = rng.standard_normal(leaf.shape) / np.sqrt(max(np.prod(leaf.shape[:-1]), 1))
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init))


def _jax_pipeline(cfg, flame_assets):
    """JAX's tiny pipeline over ``_random_like`` weights (no init compiled),
    tokenizing with the port's tokenizer, whose ids are JAX's
    (``test_torch_pipeline``) and which loads without JAX's seconds-long
    search."""
    clip_model = ClipTextModel(cfg.clip)
    brain = JBrain(out_dim=cfg.clip_size, in_dim=cfg.clip.hidden_size, clip_size=cfg.clip_size)
    net = JNet(dim=cfg.clip_size, depth=cfg.prior_depth, heads=cfg.prior_heads,
               dim_head=cfg.prior_dim_head)
    head = JHead(cfg.emote, flame_assets=flame_assets)
    lfs, k = cfg.emote.flint.latent_frame_size, jax.random.PRNGKey(0)
    params = {
        "clip": _random_like(lambda: clip_model.init(k, jnp.zeros((1, cfg.max_tokens), jnp.int32)),
                             1),
        "brain": _random_like(lambda: brain.init(k, jnp.zeros((1, cfg.clip.hidden_size))), 2),
        "prior": _random_like(lambda: net.init(k, jnp.zeros((1, 1, cfg.clip_size)),
                                               jnp.zeros((1,), jnp.int32),
                                               jnp.zeros((1, cfg.clip_size))), 3),
        "head": _random_like(lambda: head.init(k, jnp.zeros((1, lfs, 640)),
                                               style_emb=jnp.zeros((1, cfg.emote.feature_dim))), 4),
    }
    prior = JPrior(net=net, scheduler=JSched.create(cfg.timesteps),
                   text_cond_drop_prob=cfg.cond_drop_prob, image_cond_drop_prob=cfg.cond_drop_prob)
    return jgen.AviTalkingPipeline(cfg=cfg, clip_model=clip_model, brain=brain, prior=prior,
                                   head=head, params=params,
                                   tokenizer=tgen.load_tokenizer(cfg.clip.vocab_size,
                                                                 cfg.max_tokens))


def _emote_jax():
    """JAX's head at the dry run's batch (frame mask included): its
    variables, and a thunk for one adamw(1e-4) step's loss and variables."""
    cfg = JConfig.tiny()
    batch = dryrun.emote_batch(cfg, B, 2 * cfg.flint.latent_frame_size)
    jb = jax.tree.map(jnp.asarray, batch)
    head = JHead(cfg)
    cond = JCond(jb["expression"], jb["intensity"], jb["identity"], jb["shape"])
    variables = _random_like(lambda: head.init(jax.random.PRNGKey(0), jb["raw_audio"], cond), 5)
    tx = optax.adamw(LR)

    def step():
        stepped, _, m = jax.jit(JTrainer(head=head, tx=tx).train_step)(
            variables, tx.init(variables), jb, jax.random.PRNGKey(0))
        return float(m["loss"]), stepped

    return variables, step


def _prior_jax():
    """JAX's prior at the dry run's sizes: its weights, its step's draws
    rebuilt for the port (the brain's dropout masks captured from flax), the
    batch, and a thunk for the step's metrics and weights."""
    dim, in_dim = 16, 24
    brain = JBrain(out_dim=dim, in_dim=in_dim, clip_size=dim, hidden=32)
    net = JNet(dim=dim, depth=1, heads=2, dim_head=8)
    key = jax.random.PRNGKey(3)
    params = {"brain": _random_like(lambda: brain.init(key, jnp.zeros((1, in_dim))), 6),
              "prior": _random_like(lambda: net.init(key, jnp.zeros((1, 1, dim)),
                                                     jnp.zeros((1,), jnp.int32),
                                                     jnp.zeros((1, dim))), 7)}
    prior = JPrior(net=net, scheduler=JSched.create(5))
    tx, _ = jprior.make_prior_optimizer(params, LR, 1000)
    trainer = jprior.PriorTrainer(brain=brain, prior=prior, tx=tx)
    voxel, style = dryrun.prior_batch(B, in_dim, dim)
    rng = jax.random.PRNGKey(4)

    @jax.jit
    def dropout_masks(p, x, key):  # flax's Dropout outputs, kept where non-zero
        masks = []

        def capture(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
                masks.append(out != 0)
            return out

        with nn.intercept_methods(capture):
            brain.apply(p, x, deterministic=False, rngs={"dropout": key})
        return masks

    masks = dropout_masks(params["brain"], jnp.asarray(voxel), jax.random.fold_in(rng, 1))
    rng_t, rng_l = jax.random.split(jax.random.fold_in(rng, 2))
    rng_noise, rng_keep = jax.random.split(rng_l)
    draws = {"dropout": [torch.from_numpy(np.array(m)) for m in masks],
             "times": torch.from_numpy(np.asarray(
                 jax.random.randint(rng_t, (B,), 0, 5)).astype(np.int64)),
             "noise": torch.from_numpy(np.array(jax.random.normal(rng_noise, (B, 1, dim)))),
             **{k: torch.from_numpy(np.array(jax.random.uniform(r, (B, 1, 1)) >= 0.2))
                for k, r in zip(("brain_keep", "image_keep"), jax.random.split(rng_keep))}}

    def step():
        state, m = trainer.jitted_train_step(donate=False)(
            jprior.PriorTrainState.create(params, tx), jnp.asarray(voxel), jnp.asarray(style),
            rng)
        return {k: float(v) for k, v in m.items()}, state.params

    return params, draws, (voxel, style), step


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's weights, draws and noise handed to the port's 4-process dry run;
    JAX's jitted steps and serving compile and run while the ranks do."""
    variables, emote_step = _emote_jax()
    pparams, draws, pbatch, prior_step = _prior_jax()
    jp = _jax_pipeline(jgen.PipelineConfig.tiny(), jassets.synthetic_assets(n_shape=8, n_exp=6))
    wavs = dryrun.serve_wavs(N // 2 + 1)
    texts = ["a happy person speaks"] * len(wavs)
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    inputs = {"case1": {"state": emote_head_state_from_jax(np_(variables))},
              "case2": {"state": prior_trainer_state_from_jax(np_(pparams)), "draws": draws,
                        "batch": pbatch},
              "case4": {"state": pipeline_state_from_jax(np_(jp.params)),
                        "noise": _ddpm_noise(2, (len(wavs), 1, jp.cfg.clip_size),
                                             jp.cfg.timesteps)}}
    tmp = tmp_path_factory.mktemp("dryrun")
    torch.save(inputs, tmp / "inputs.pt")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(dryrun.dryrun_multichip, N, "cpu", inputs=str(tmp / "inputs.pt"),
                           workdir=str(tmp))
        out = {"emote": emote_step(), "prior": prior_step(),
               "serve": jp.generate_batch(wavs, texts, seed=2, length_buckets=(32,),
                                          return_vertices=False)}
        out["port"] = port.result(timeout=600)
    return out


def test_mesh_is_dp2_tp2(run):
    assert (run["port"]["dp"], run["port"]["tp"]) == (2, 2)


@pytest.mark.parametrize("case,key", [("case1", "loss_tp_rel"), ("case1", "loss_fsdp_rel"),
                                      ("case2", "loss_dp_rel"), ("case3", "loss_rel")])
def test_sharded_loss_is_the_unsharded_one(run, case, key):
    """Case 1's batch masks the second half of its rows (rank 1's under dp)
    over unequal stretches, so its masked means need the global count; case
    2's rows differ by rank, so its NCE term needs the global batch: 1e-5
    relative."""
    assert run["port"][case][key] <= 1e-5


@pytest.mark.parametrize("case,key", [("case1", "tp"), ("case1", "fsdp"), ("case2", "dp"),
                                      ("case3", "dp_tp")])
def test_sharded_gradients_are_the_unsharded_ones(run, case, key):
    """Every gradient within 1e-5 of the largest (``hold_step``)."""
    held = run["port"][case][key]
    assert held["grad_err"] <= 1e-5 * held["grad_max"] and held["grad_max"] > 0


@pytest.mark.parametrize("rank", range(N))
def test_q_proj_shard_moves_on_every_rank(run, rank):
    """Under tp=2 each rank holds half of q_proj's outputs (its heads), and
    the step moves them."""
    c = run["port"]["case1"]
    assert c["q_proj_shard"] == (16, 32) and len(c["q_proj_moved_by_rank"]) == N
    assert c["q_proj_moved_by_rank"][rank] > 0


def test_replicated_gradient_is_not_doubled_or_zero(run):
    """A tp-replicated weight's gradient equals the unsharded one: reduced
    over dp only, not counted tp times."""
    assert abs(run["port"]["case1"]["replicated_grad_ratio"] - 1) < 1e-4


def test_fsdp_places_a_column_weight_on_both_axes(run):
    """FSDP over tp: a column weight splits its outputs over tp, its inputs
    over dp (JAX's ``fsdp_extend_spec`` on the torch weight's shape)."""
    assert run["port"]["case1"]["fsdp_placements"][
        "audio_encoder.encoder.layers.0.attention.q_proj.weight"] == ("S(1)", "S(0)")


@pytest.mark.parametrize("key", ["loss_tp", "loss_fsdp"])
def test_emote_step_loss_matches_jax(run, key):
    """The sharded step's loss against JAX's replicated step
    (``test_torch_emote_train``'s 1e-4)."""
    np.testing.assert_allclose(run["port"]["case1"][key], run["emote"][0], rtol=1e-4, atol=0)


def test_emote_step_weights_match_jax(run):
    """The tp step's weights against JAX's (``test_torch_emote_train``'s
    rule: 1e-4, the key biases 2·lr)."""
    tm = dryrun.build_emote_head(True, "cpu")
    tm.load_state_dict(run["port"]["case1"]["state_tp"])
    _assert_state_matches(tm, run["emote"][1], 1, LR)


@pytest.mark.parametrize("key", ["loss", "loss_nce", "loss_prior", "cosine_sim", "top1"])
def test_prior_step_metrics_match_jax(run, key):
    """The dp step's metrics (the NCE term and the top-1 over the gathered
    batch) against JAX's replicated step: the losses 1e-4 relative, the
    cosine 1e-5, the top-1 exactly (``test_torch_prior_train``'s rules)."""
    got, want = run["port"]["case2"]["metrics"], run["prior"][0]
    if key == "top1":
        assert (got["top1_fwd"], got["top1_bwd"]) == (want["top1_fwd"], want["top1_bwd"])
    elif key == "cosine_sim":
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=0)


def test_prior_step_weights_match_jax(run):
    ref = prior_trainer_state_from_jax(jax.tree.map(np.asarray, run["prior"][1]))
    for k, v in run["port"]["case2"]["state_dp"].items():
        part, name = k.split(".", 1)
        np.testing.assert_allclose(v.numpy(), ref[part][name], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("term", ["loss_lipread_disentangled", "loss_emotion_disentangled",
                                  "loss_video_emotion_disentangled", "loss_lipread",
                                  "loss_exp"])
def test_neural_terms_are_the_unsharded_ones(run, term):
    """Condition exchange over the global batch (its conditions, EmoNet
    targets and labels gathered) and the lip-reading mean over the global
    mask count: each term 1e-5 relative."""
    assert run["port"]["case3"]["term_rel"][term] <= 1e-5


def test_served_rows_are_the_unsharded_ones(run):
    """dp + 1 requests, padded with the first row: 1e-6 of the largest."""
    c = run["port"]["case4"]
    assert c["clips"] == 3 and c["max_err"] <= 1e-6 * max(c["largest"], 1.0)


@pytest.mark.parametrize("clip", range(3))
def test_served_rows_match_jax(run, clip):
    """Each request's exp / jaw / style against JAX's unsharded
    ``generate_batch`` on the same noise (``test_torch_pipeline``'s 1e-4)."""
    got, ref = run["port"]["case4"]["outputs"][clip], run["serve"][clip]
    for k in ("exp", "jaw", "style_emb"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), atol=1e-4, rtol=0, err_msg=k)
