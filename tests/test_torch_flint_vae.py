"""Port parity, the FLINT motion prior (``models.flint_vae``) and its
trainer: the VAE and VQ-VAE forwards and losses in eval and train mode (the
BatchNorms' batch statistics and flax's running-statistics update) at 1e-5
of the largest value, the Gumbel quantizer on JAX's ``u``, three
``train_flint_vae`` steps per mode against JAX's jitted step
(``train_flint_vae``'s) from the port's seeded weights, carried to JAX by
JAX's own torch importers and back by ``infra.jax_params`` (each step's
metrics, every parameter and every running statistic at 1e-4), and
``train-flint --tiny`` on synthetic motion and on a MEAD tree the test
builds (its batches equal to JAX's command's). The forwards run JAX
eagerly: at these widths that is cheaper than compiling them."""

import itertools
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avi_talking_tpu.data import MeadEmocaDataset as JMead
from avi_talking_tpu.data import train_batches as jtb
from avi_talking_tpu.models import flint_vae as jfv
from avi_talking_tpu.models.flint import FlintConfig as JConfig
from avi_talking_tpu.infra import torch_compat as tc
from avi_talking_tpu.infra.emote_import import _flint_decoder_params
from avi_talking_tpu_torch.cli import main
from avi_talking_tpu_torch.cli.train_emote import flint_batches, flint_config
from avi_talking_tpu_torch.infra.checkpoint import restore_checkpoint
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.infra.jax_params import flint_vae_state_from_jax
from avi_talking_tpu_torch.models import flint_vae as tfv
from avi_talking_tpu_torch.train.driver import train_flint_vae
from _torch_threads import one_torch_thread  # noqa: F401

TINY = dict(feature_dim=32, bottleneck_dim=32, quant_factor=2, nhead=4, intermediate_size=64,
            out_dim=9, n_exp=6)  # the commands' --tiny
B, T = 4, 16
TOL = 1e-5
STEP_TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(factory, variables):
    m = random_module(factory, torch.device("cpu"), torch.Generator().manual_seed(0))
    state = {k: torch.as_tensor(v) for k, v in flint_vae_state_from_jax(_np(variables)).items()}
    missing, unexpected = m.load_state_dict(state, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return m


def _motion(seed=0, batch=B, frames=T):
    return np.random.default_rng(seed).standard_normal((batch, frames, 9)).astype(np.float32)


def _perturbed(variables, seed):
    """BatchNorm statistics away from 0 / 1 and its affines away from 1 / 0,
    so a running-versus-batch mix-up cannot hide. The layers' own biases
    stay: a channel whose mean is large against its spread makes flax's
    train-mode variance, ``mean(x^2) - mean(x)^2``, cancel, and two right
    summation orders then part far above 1e-5 (a 0.2 bias under the
    VQ-VAE's codebook of +-1/256 parts them by 1e-3)."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        name = path[-1].key
        if name == "var":
            return (rng.random(a.shape) + 0.5).astype(np.float32)
        if name == "mean" or (name in ("scale", "bias") and path[-2].key == "bn"):
            return (a + rng.standard_normal(a.shape) * 0.2).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(move, _np(variables))


def _factory(quantizer):
    cfg = tfv.FlintConfig(**TINY)
    return (lambda: tfv.FlintVQVAE(cfg)) if quantizer else (lambda: tfv.FlintVAE(cfg))


def _stream(seed):
    rng = np.random.default_rng(seed)
    while True:
        yield rng.standard_normal((B, T, 9)).astype(np.float32) * 0.1


def _seeded(quantizer, seed=0):
    return random_module(_factory(quantizer), torch.device("cpu"),
                         torch.Generator().manual_seed(seed))


def _to_jax(tm, quantizer):
    """The port's state -> JAX's variables, through JAX's own torch importers
    (``infra.torch_compat``; the decoder through ``emote_import``'s)."""
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    enc, q = sub("encoder."), TINY["quant_factor"]
    params, stats = {}, {}
    for i in range(q):
        params[f"squasher_{i}_conv"] = tc.conv1d_params(enc, f"squasher.{i}.0.")
        bn = tc.batchnorm1d_params(enc, f"squasher.{i}.2.")
        params[f"squasher_{i}_post"] = {"bn": bn["params"]}
        stats[f"squasher_{i}_post"] = {"bn": bn["batch_stats"]}
    params["encoder_linear_embedding"] = tc.linear_params(enc, "encoder_linear_embedding.")
    params["encoder_transformer"] = tc.encoder_params(enc, "encoder_transformer.", 1)
    dec = _flint_decoder_params(sub("decoder."), q)
    out = {"params": {"encoder": params, "decoder": dec["params"]},
           "batch_stats": {"encoder": stats, "decoder": dec["batch_stats"]}}
    if quantizer:
        out["params"]["quantizer"] = {"embedding": sd["quantizer.embedding"]}
    else:
        for name in ("mean", "logvar"):
            out["params"][name] = tc.linear_params(sd, name + ".")
    return out


def _jax_steps(quantizer, variables, steps=3, lr=1e-4, seed=0):
    """``steps`` steps of JAX's FLINT step as ``train_flint_vae`` builds and
    jits it (its body verbatim), from ``variables`` on ``_stream(1)``, step i
    keyed ``fold_in(PRNGKey(seed), i)``; -> the last metrics, params and
    statistics."""
    import optax

    cfg = JConfig(**TINY)
    vae = jfv.FlintVQVAE(cfg) if quantizer else jfv.FlintVAE(cfg)
    params, stats = variables["params"], variables["batch_stats"]
    tx = optax.adamw(lr)
    opt = tx.init(params)

    @jax.jit
    def step(params, stats, opt, motion, key):
        def lf(p):
            if quantizer == "vq":
                (loss, m), new_model_state = vae.apply(
                    {"params": p, "batch_stats": stats}, motion, True,
                    method=jfv.FlintVQVAE.loss, mutable=["batch_stats"])
            else:
                (loss, m), new_model_state = vae.apply(
                    {"params": p, "batch_stats": stats}, motion, key, 0.01, True,
                    method=jfv.FlintVAE.loss, mutable=["batch_stats"])
            return loss, (m, new_model_state)

        (loss, (m, new_state)), g = jax.value_and_grad(lf, has_aux=True)(params)
        upd, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, upd), new_state["batch_stats"], opt, m

    rng = jax.random.PRNGKey(seed)
    history = []
    for i, motion in enumerate(itertools.islice(_stream(1), steps)):
        params, stats, opt, m = step(params, stats, opt, jnp.asarray(motion),
                                     jax.random.fold_in(rng, i))
        history.append({k: float(v) for k, v in m.items()})
    return {"params": params, "batch_stats": stats, "metrics": history[-1], "history": history}


@pytest.fixture(scope="module")
def models():
    """The JAX modules on the port's seeded weights carried to JAX, their
    statistics and affines perturbed."""
    cfg = JConfig(**TINY)
    return {
        "vae": (jfv.FlintVAE(cfg), _perturbed(_to_jax(_seeded(None, 1), None), 1),
                _factory(None)),
        "vq": (jfv.FlintVQVAE(cfg), _perturbed(_to_jax(_seeded("vq", 2), "vq"), 2),
               _factory("vq")),
    }


def _close(got, ref, tol=TOL, what=""):
    """Within ``tol`` of the reference's largest magnitude (at least 1): the
    train-mode BatchNorms' variance, ``mean(x^2) - mean(x)^2`` in both
    packages, cancels where a channel's mean is large against its spread,
    and the two summation orders then part by a few ulps of the mean."""
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(np.asarray(got.detach()), ref, atol=tol * scale, rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("train", [False, True])
def test_vae_forward_and_loss_match_jax(models, train):
    """Outputs, loss terms and, in train mode, the updated running
    statistics, with JAX's sampling noise passed in."""
    jm, variables, factory = models["vae"]
    x, key = _motion(3), jax.random.PRNGKey(7)

    out, jstate = jm.apply(variables, jnp.asarray(x), key, train=train, mutable=["batch_stats"])
    (jloss, jmet), _ = jm.apply(variables, jnp.asarray(x), key, 0.01, train,
                                method=jfv.FlintVAE.loss, mutable=["batch_stats"])
    noise = np.array(jax.random.normal(key, out["mu"].shape))
    tm = _port(factory, variables).train(train)
    got = tm(torch.from_numpy(x), torch.from_numpy(noise))
    for k in ("reconstruction", "mu", "logvar", "z"):
        _close(got[k], out[k], what=k)
    if train:
        want = flint_vae_state_from_jax({"params": variables["params"],
                                         "batch_stats": _np(jstate["batch_stats"])})
        stats = {k: v for k, v in tm.state_dict().items() if k.endswith(("_mean", "_var"))}
        assert len(stats) == 2 * (2 * TINY["quant_factor"])
        for k, v in stats.items():
            _close(v, want[k], what=k)
    tm = _port(factory, variables).train(train)
    loss, met = tm.loss(torch.from_numpy(x), torch.from_numpy(noise), 0.01)
    _close(loss, jloss, what="loss")
    for k in ("recon", "kl"):
        _close(met[k], jmet[k], what=k)


@pytest.mark.parametrize("train", [False, True])
def test_vqvae_forward_and_loss_match_jax(models, train):
    """Codes equal; quantized features, reconstruction and every loss term
    (perplexity included) within 1e-5 (256 codes, JAX's loop's); the straight-through gradient
    reaches the encoder and the commitment term the codebook."""
    jm, variables, factory = models["vq"]
    x = _motion(4)
    out, _ = jm.apply(variables, jnp.asarray(x), train, mutable=["batch_stats"])
    (jloss, jmet), _ = jm.apply(variables, jnp.asarray(x), train, method=jfv.FlintVQVAE.loss,
                                mutable=["batch_stats"])
    tm = _port(factory, variables).train(train)
    got = tm(torch.from_numpy(x))
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(out["codes"]))
    for k in ("quantized", "reconstruction", "alignment", "commitment", "perplexity"):
        _close(got[k], out[k], what=k)
    tm = _port(factory, variables).train(train)
    loss, met = tm.loss(torch.from_numpy(x))
    _close(loss, jloss, what="loss")
    for k in jmet:
        _close(met[k], jmet[k], what=k)
    loss.backward()
    assert float(tm.quantizer.embedding.grad.abs().max()) > 0
    assert float(tm.encoder.squasher[0][0].weight.grad.abs().max()) > 0


@pytest.mark.parametrize("with_noise", [True, False])
def test_gumbel_quantizer_matches_jax(with_noise):
    """Soft assignments, z_q, KL, codes and perplexity on JAX's Gumbel draw
    ``u``; ``codebook_entry`` gathers the codebook."""
    K, D = 12, 5
    jq = jfv.GumbelVectorQuantizer(K, D)
    logits = np.random.default_rng(5).standard_normal((2, 7, K)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    params = jq.init(jax.random.PRNGKey(1), jnp.asarray(logits))
    out = jq.apply(params, jnp.asarray(logits), key if with_noise else None)
    tq = tfv.GumbelVectorQuantizer(K, D)
    with torch.no_grad():
        tq.embedding.copy_(torch.from_numpy(np.asarray(params["params"]["embedding"])))
    u = None
    if with_noise:
        u = torch.from_numpy(np.asarray(
            jax.random.uniform(key, (14, K), jnp.float32, 1e-10, 1.0)))
    got = tq(torch.from_numpy(logits), u)
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(out["codes"]))
    for k in ("soft_assignments", "quantized", "kl_divergence", "perplexity"):
        _close(got[k], out[k], what=k)
    idx = np.array([[0, 3], [11, 5]])
    np.testing.assert_array_equal(
        tfv.GumbelVectorQuantizer.codebook_entry(tq.embedding, torch.from_numpy(idx))
        .detach().numpy(),
        np.asarray(jfv.GumbelVectorQuantizer.codebook_entry(params["params"]["embedding"],
                                                            jnp.asarray(idx))))


@pytest.fixture(scope="module", params=[None, "vq"], ids=["vae", "vq"])
def trained(request, tmp_path_factory):
    """The port's ``train_flint_vae`` and JAX's step from the same seeded
    weights on the same batches and, for the VAE, JAX's per-step noise
    (``normal(fold_in(PRNGKey(seed), i))``)."""
    quantizer, lr = request.param, 1e-4
    tm = _seeded(quantizer)
    ref = _jax_steps(quantizer, _to_jax(tm, quantizer), lr=lr)
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    key = jax.random.PRNGKey(0)

    def noise(i, shape):
        return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, i), shape)))

    history, loss = [], tm.loss

    def recorded(*args, **kwargs):  # each step's metrics, as JAX's loop returns them
        out = loss(*args, **kwargs)
        history.append({k: float(v) for k, v in out[1].items()})
        return out

    tm.loss = recorded
    ck = str(tmp_path_factory.mktemp("flint_ck"))
    got = train_flint_vae(_stream(1), total_steps=3, flint_cfg=tfv.FlintConfig(**TINY), lr=lr,
                          seed=0, quantizer=quantizer, device="cpu", vae=tm, noise=noise,
                          ckpt_dir=ck)
    del tm.loss
    return {"ref": ref, "got": got, "history": history, "start": start, "lr": lr, "ck": ck}


def test_train_flint_vae_three_steps_match_jax(trained):
    """Each step's metrics, every parameter and every running statistic
    at 1e-4, but the attention key biases (their exact gradient is 0: each
    AdamW step moves them by up to lr along rounding noise, so two right
    implementations part by up to 2 lr a step); the steps moved both."""
    ref, got, lr = trained["ref"], trained["got"], trained["lr"]
    assert len(trained["history"]) == len(ref["history"]) == 3
    assert got["metrics"] == trained["history"][-1]
    for i, (tmet, jmet) in enumerate(zip(trained["history"], ref["history"])):
        assert set(tmet) == set(jmet)
        for k, v in jmet.items():
            np.testing.assert_allclose(tmet[k], v, atol=STEP_TOL, rtol=0, err_msg=f"step {i} {k}")
    want = flint_vae_state_from_jax(_np({"params": ref["params"],
                                         "batch_stats": ref["batch_stats"]}))
    state = got["vae"].state_dict()
    assert set(want) == set(state)
    for k, v in want.items():
        g = state[k].numpy()
        if k.endswith("in_proj_bias"):
            d = v.shape[0] // 3
            np.testing.assert_allclose(g[d:2 * d], v[d:2 * d], atol=2 * lr * 3 + 1e-7, rtol=0,
                                       err_msg=k)
            g, v = np.concatenate([g[:d], g[2 * d:]]), np.concatenate([v[:d], v[2 * d:]])
        np.testing.assert_allclose(g, v, atol=STEP_TOL, rtol=0, err_msg=k)
    moved = {k: float((state[k] - trained["start"][k]).abs().max()) for k in state
             if not k.endswith("num_batches_tracked")}
    assert max(v for k, v in moved.items() if k.endswith("weight")) > 2e-4
    assert min(v for k, v in moved.items() if k.endswith(("_mean", "_var"))) > 0


def test_train_flint_checkpoint_round_trip(trained):
    """``{"params", "batch_stats"}`` load back into a fresh module bit-equal."""
    saved = restore_checkpoint(trained["ck"])
    assert set(saved) == {"params", "batch_stats"}
    vae = trained["got"]["vae"]
    fresh = random_module(lambda: type(vae)(tfv.FlintConfig(**TINY)), torch.device("cpu"),
                          torch.Generator().manual_seed(9))
    fresh.load_state_dict({**saved["params"], **saved["batch_stats"]}, strict=False)
    for k, v in vae.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, atol=0, rtol=0)


def _write_clip(root, name, rng, frames=20):
    base = root / name / "EMOCA_v2_lr_mse_20"
    for i in range(frames):
        fd = base / f"{i:06d}_000"
        fd.mkdir(parents=True)
        np.save(fd / "exp.npy", rng.standard_normal(50).astype(np.float32))
        np.save(fd / "pose.npy", rng.standard_normal(6).astype(np.float32) * 0.1)
        np.save(fd / "shape.npy", rng.standard_normal(100).astype(np.float32))
        np.save(fd / "cam.npy", rng.standard_normal(3).astype(np.float32))
    with wave.open(str(root / name / f"{name}.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.zeros(16000 * frames // 25, np.int16).tobytes())


@pytest.fixture(scope="module")
def mead_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("flint_mead")
    rng = np.random.default_rng(0)
    for ident in ("M003", "W009"):
        for emo, lvl in (("neutral", 1), ("happy", 2)):
            _write_clip(root, f"{ident}_front_{emo}_level{lvl}_001", rng)
    return str(root)


def test_flint_batches_match_jax_command(mead_root):
    """``--root``'s batches equal the JAX command's (``EmoteBatchBuilder``
    windows, exp + jaw), and the synthetic stream its draws."""
    cfg = flint_config(tiny=True)
    args = type("A", (), {"root": mead_root, "batch_size": 3, "tiny": True, "seed": 4})()
    builder = jtb.EmoteBatchBuilder(JMead(root=mead_root, seq_length=8), frames=8, n_exp=6,
                                    n_shape=8)
    want = [np.concatenate([b["gt_exp"], b["gt_jaw"]], axis=-1)
            for b in itertools.islice(jtb.emote_batches(builder, 3, epochs=None), 3)]
    for g, w in zip(itertools.islice(flint_batches(args, cfg, 8), 3), want):
        np.testing.assert_array_equal(g, w)
    args.root = None
    rng = np.random.default_rng(4)
    for g in itertools.islice(flint_batches(args, cfg, 8), 2):
        np.testing.assert_array_equal(g, rng.standard_normal((3, 8, 9)).astype(np.float32) * 0.1)


@pytest.mark.parametrize("extra", [[], ["--vq"], ["--root"]], ids=["vae", "vq", "root"])
def test_train_flint_command(extra, mead_root, tmp_path, capsys, monkeypatch):
    """``train-flint --tiny --device cpu``: two steps, finite final metrics,
    the checkpoint and the ``flint/`` scalars at step 50's cadence (none in
    two steps, so the log holds no line). TensorBoard's import (TensorFlow's,
    tens of seconds on one core) is blocked: the JSONL is written without
    it, as when it is not installed."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    if extra == ["--root"]:
        extra = ["--root", mead_root]
    ck, logs = tmp_path / "ck", tmp_path / "logs"
    assert main(["train-flint", "--tiny", "--device", "cpu", "--steps", "2", "--batch-size", "2",
                 "--frames", "16", "--ckpt-dir", str(ck), "--logdir", str(logs)] + extra) == 0
    out = capsys.readouterr().out
    final = [line for line in out.splitlines() if line.startswith("final:")]
    assert len(final) == 1
    metrics = eval(final[0][len("final:"):])  # a printed dict of floats
    assert all(np.isfinite(v) for v in metrics.values())
    assert ("perplexity" in metrics) == ("--vq" in extra)
    assert set(restore_checkpoint(str(ck))) == {"params", "batch_stats"}
    assert (logs / "scalars.jsonl").read_text() == ""
    if "--root" in extra:
        assert "data root: 4 clips" in out


def test_train_flint_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train-flint", "--tiny", "--steps", "1"])
