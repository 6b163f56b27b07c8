"""Port parity, the reference-checkpoint importers and the asset commands.

Synthetic state dicts under the reference's key names and shapes (no
published weights are in the repository) go through JAX's importer, carried
to the port's names by ``infra.jax_params``, and through the port's
importer; the two must be bit-equal. Then the commands: ``import-prior`` ->
``generate --checkpoint``, its refusal without a CLIP vocab, ``import-clip``,
``save`` / ``load``, ``load_prior_checkpoint`` after training,
``train-prior --pipeline-checkpoint / --emote-checkpoint``,
``convert-flame`` and ``stats`` against JAX's on the same files.
"""

import dataclasses
import pickle
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from avi_talking_tpu.audio.import_hf import wav2vec2_params_from_torch
from avi_talking_tpu.cli import reconstruct as jreconstruct
from avi_talking_tpu.core import assets as jassets
from avi_talking_tpu.infra import checkpoint as jckpt
from avi_talking_tpu.infra.emote_import import emote_params_from_torch
from avi_talking_tpu.models import emote as jemote
from avi_talking_tpu.models.clip_text import clip_text_params_from_torch
from avi_talking_tpu.models.conditioning import StyleCondition as JCondition
from avi_talking_tpu_torch.audio import wav2vec2 as tw2v
from avi_talking_tpu_torch.cli import main
from avi_talking_tpu_torch.core import assets as tassets
from avi_talking_tpu_torch.infra import checkpoint as tckpt
from avi_talking_tpu_torch.infra import jax_params as jp
from avi_talking_tpu_torch.infra.emote_import import emote_state_from_torch
from avi_talking_tpu_torch.infra.init import random_module
from avi_talking_tpu_torch.models import clip_text as tclip
from avi_talking_tpu_torch.models import emote as temote
from avi_talking_tpu_torch.models.conditioning import StyleCondition
from avi_talking_tpu_torch.pipeline import AviTalkingPipeline, PipelineConfig
from avi_talking_tpu_torch.text.clip_bpe import (ClipBpeTokenizer, save_vocab_files,
                                                 validate_tokenizer_assets)

from test_torch_train_data import mead_root  # noqa: F401  (the MEAD tree fixture)
from _torch_threads import one_torch_thread  # noqa: F401


def _random_state(factory, seed):
    m = random_module(factory, torch.device("cpu"), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in m.state_dict().items():  # non-trivial norms and statistics
        if k.endswith("num_batches_tracked"):
            out[k] = v.clone()
        elif k.endswith("running_var"):
            out[k] = torch.from_numpy((0.5 + rng.random(v.shape)).astype(np.float32))
        else:
            out[k] = v + torch.from_numpy((0.1 * rng.standard_normal(v.shape)).astype(np.float32))
    return out


def _as_np(sd):
    return {k: np.asarray(v) for k, v in sd.items()}


def assert_states_bit_equal(got, ref):
    got = {k: np.asarray(v) for k, v in got.items()}
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ------------------------------------------------------- reference layouts --


def _weight_norm(sd, prefix, spelling, seed):
    """Replace ``prefix + weight`` (O, I, K) with a weight norm of the same
    shape, g over dim 2 as torch's ``weight_norm(dim=2)``."""
    rng = np.random.default_rng(seed)
    w = sd.pop(prefix + "weight").numpy()
    g = (0.5 + rng.random((1, 1, w.shape[2]))).astype(np.float32)
    names = {"old": ("weight_g", "weight_v"),
             "new": ("parametrizations.weight.original0", "parametrizations.weight.original1")}
    gk, vk = names[spelling]
    sd[prefix + gk] = torch.from_numpy(g)
    sd[prefix + vk] = torch.from_numpy(w)


def reference_emote_sd(cfg, squash="stack_linear", prefix="talking_head_model.",
                       vq_leftovers=False, spelling="new", seed=0):
    """An inferno EMOTE checkpoint's state dict, built from the port's head
    at seeded random weights: the same tensors under the reference's keys."""
    st = _random_state(lambda: temote.EmoteTalkingHead(cfg, condition_dim=8 + 3 + 4 + cfg.n_shape),
                       seed)
    sq = "squasher_2.linear." if squash == "stack_linear" else "squasher."
    rename = [("audio_encoder.", "audio_model.model."),
              ("sequence_encoder.", "sequence_encoder.linear."),
              ("style_encoder.map.", "sequence_decoder.obj_vector.map."),
              ("bert_decoder.", "sequence_decoder.bert_decoder."),
              ("decoder.", "sequence_decoder.decoder."),
              ("squasher.", "sequence_decoder." + sq),
              ("motion_prior.", "sequence_decoder.motion_prior.motion_decoder.")]
    sd = {}
    for k, v in st.items():
        src, dst = next((s, d) for s, d in rename if k.startswith(s))
        sd[prefix + dst + k[len(src):]] = v
    _weight_norm(sd, prefix + "audio_model.model.encoder.pos_conv_embed.conv.", spelling, seed)
    if vq_leftovers:
        mp = prefix + "sequence_decoder.motion_prior."
        sd[mp + "motion_encoder.squasher.0.0.weight"] = torch.zeros(4, 4, 5)
        sd[mp + "motion_quantizer.codebook.weight"] = torch.zeros(16, 4)
        sd[mp + "preprocessor.mean"] = torch.zeros(3)
        sd[prefix + "preprocessor.some_buffer"] = torch.zeros(1)
    return sd


def _emote_cfg(squash):
    if squash == "stack_linear":
        return jemote.EmoteConfig.tiny(), temote.EmoteConfig.tiny()
    return (dataclasses.replace(jemote.EmoteConfig.tiny(), squash_type="conv", squash_before=True),
            dataclasses.replace(temote.EmoteConfig.tiny(), squash_type="conv", squash_before=True))


EMOTE_VARIANTS = [
    dict(squash="stack_linear", prefix="talking_head_model.", spelling="new"),
    dict(squash="stack_linear", prefix="", spelling="old"),
    dict(squash="conv", prefix="talking_head_model.", spelling="new"),
    dict(squash="stack_linear", prefix="talking_head_model.", spelling="new", vq_leftovers=True),
]


@pytest.mark.parametrize("variant", EMOTE_VARIANTS, ids=lambda v: "-".join(map(str, v.values())))
def test_emote_import_bit_equal_to_jax(variant):
    """Every variant: both squashers, Lightning and bare prefixes, both
    weight-norm spellings, VQ leftovers ignored. The weight norm computes in
    numpy float32 in both packages, the same ops in the same order, so it
    too is bit-equal (the stated limit would be 1e-7 relative)."""
    jcfg, tcfg = _emote_cfg(variant["squash"])
    sd = reference_emote_sd(tcfg, **variant)
    ref = jp.emote_head_state_from_jax(jax.tree.map(np.asarray, emote_params_from_torch(sd, jcfg)))
    got = emote_state_from_torch(sd, tcfg)
    assert_states_bit_equal(got, ref)
    head = temote.EmoteTalkingHead(tcfg, condition_dim=8 + 3 + 4 + tcfg.n_shape)
    head.load_state_dict(got)  # every key the port's head has, nothing else


def test_import_emote_config_file(tmp_path):
    """``import-emote --config`` reads the file with ``infra.config.from_dict``
    (nested dataclasses, lists as tuples) as JAX's ``load_config`` does: a
    conv-squasher config written by ``save_config`` imports bit-equal to the
    importer called with the config itself; an unknown field raises."""
    from avi_talking_tpu_torch.infra.config import save_config

    _, tcfg = _emote_cfg("conv")
    torch.save({"state_dict": reference_emote_sd(tcfg, squash="conv")}, tmp_path / "e.ckpt")
    save_config(tcfg, str(tmp_path / "cfg.json"))
    assert main(["import-emote", "--ckpt", str(tmp_path / "e.ckpt"), "--config",
                 str(tmp_path / "cfg.json"), "--out", str(tmp_path / "ck")]) == 0
    got = tckpt.restore_checkpoint(str(tmp_path / "ck"))["head"]
    want = emote_state_from_torch(reference_emote_sd(tcfg, squash="conv"), tcfg)
    assert_states_bit_equal(got, _as_np(want))
    (tmp_path / "bad.json").write_text('{"no_such_field": 1}')
    with pytest.raises(KeyError, match="unknown config field EmoteConfig.no_such_field"):
        main(["import-emote", "--ckpt", str(tmp_path / "e.ckpt"), "--config",
              str(tmp_path / "bad.json"), "--out", str(tmp_path / "ck2")])


def test_emote_import_forward_matches_jax():
    """One tiny forward on the imported weights, condition through the
    style encoder: port vs JAX at the JAX suite's EMOTE import tolerance
    (rtol 2e-3, atol 2e-4)."""
    jcfg, tcfg = _emote_cfg("stack_linear")
    sd = reference_emote_sd(tcfg, seed=3)
    frames = np.random.default_rng(0).standard_normal((2, 8, 640)).astype(np.float32)
    ckw = dict(emotion_idx=3, intensity_idx=1, identity_idx=2, batch=2, n_identities=4,
               shape_dim=tcfg.n_shape)
    ref = jax.jit(lambda v, f: jemote.EmoteTalkingHead(jcfg).apply(v, f, JCondition.make(**ckw)))(
        emote_params_from_torch(sd, jcfg), jnp.asarray(frames))
    head = temote.EmoteTalkingHead(tcfg, condition_dim=8 + 3 + 4 + tcfg.n_shape)
    head.load_state_dict(emote_state_from_torch(sd, tcfg))
    with torch.no_grad():
        got = head.eval()(torch.from_numpy(frames), condition=StyleCondition.make(**ckw))
    for key in ("exp", "jaw"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=2e-3, atol=2e-4)


def test_emote_checkpoint_with_an_unknown_key_raises_in_both():
    """A renamed key (the decoder's weight under an unknown name): JAX's
    importer raises KeyError; the port's too, naming the unread key."""
    jcfg, tcfg = _emote_cfg("stack_linear")
    sd = reference_emote_sd(tcfg)
    sd["talking_head_model.sequence_decoder.decoderX.weight"] = sd.pop(
        "talking_head_model.sequence_decoder.decoder.weight")
    with pytest.raises(KeyError):
        emote_params_from_torch(sd, jcfg)
    with pytest.raises(KeyError, match="decoderX"):
        emote_state_from_torch(sd, tcfg)
    with pytest.raises(ValueError, match="squasher"):  # config / layout mismatch, as JAX
        emote_state_from_torch(reference_emote_sd(_emote_cfg("conv")[1], squash="conv"), tcfg)


@pytest.mark.parametrize("spelling", ["old", "new"])
def test_wav2vec2_import_bit_equal_to_jax(spelling):
    """HF names with the positional conv's weight norm in either spelling."""
    sd = _random_state(lambda: tw2v.Wav2Vec2Model(tw2v.Wav2Vec2Config.tiny()), 4)
    _weight_norm(sd, "encoder.pos_conv_embed.conv.", spelling, 4)
    sd = {"wav2vec2." + k: v for k, v in sd.items()}
    ref = jp.wav2vec2_state_from_jax(wav2vec2_params_from_torch(
        sd, jemote.EmoteConfig.tiny().wav2vec2, prefix="wav2vec2."))
    assert_states_bit_equal(tw2v.wav2vec2_state_from_torch(sd, tw2v.Wav2Vec2Config.tiny(),
                                                           prefix="wav2vec2."), ref)


def test_clip_text_import_bit_equal_to_jax():
    """HF ``CLIPTextModel`` names (``text_model.`` and its position_ids
    buffer) -> the port's ``ClipTextModel``."""
    cfg = tclip.ClipTextConfig.tiny()
    st = _random_state(lambda: tclip.ClipTextModel(cfg), 5)
    sd = {"text_model." + k: v for k, v in st.items()}
    sd["text_model.embeddings.position_ids"] = torch.arange(16)[None]
    from avi_talking_tpu.models.clip_text import ClipTextConfig as JClipConfig

    ref = jp.clip_text_state_from_jax(clip_text_params_from_torch(sd, JClipConfig.tiny()))
    got = tclip.clip_text_state_from_torch(sd)
    assert_states_bit_equal(got, ref)


# ------------------------------------------------------------ the prior --


def reference_prior_pth(path, brain, prior, ff_net=False):
    """The reference prior trainer's ``last.pth`` layout for the given brain and
    prior-network states; ``ff_net`` spells the feed-forward
    ``layers.{i}.1.net.{0,1,5}``."""
    sd = {"voxel2clip." + k: v for k, v in brain.items()}
    for k, v in prior.items():
        parts = k.split(".")
        if ff_net and k.startswith("causal_transformer.layers.") and parts[3] == "1":
            k = ".".join(parts[:4] + ["net"] + parts[4:])
        sd["net." + k] = v
    torch.save({"epoch": 3, "model_state_dict": sd}, path)
    return path


@pytest.fixture(scope="module")
def tiny_prior_states():
    pipe = AviTalkingPipeline.random_init(PipelineConfig.tiny(), seed=7, device="cpu")
    rng = np.random.default_rng(7)
    return {part: {k: v + torch.from_numpy((0.1 * rng.standard_normal(v.shape)).astype(np.float32))
                   for k, v in sd.items()}
            for part, sd in (("brain", pipe.brain.state_dict()),
                             ("prior", pipe.prior.net.state_dict()))}


@pytest.mark.parametrize("ff_net", [False, True])
def test_prior_import_bit_equal_to_jax(tmp_path, tiny_prior_states, ff_net):
    path = reference_prior_pth(str(tmp_path / "last.pth"), **tiny_prior_states, ff_net=ff_net)
    ref = jp.prior_trainer_state_from_jax(jax.tree.map(np.asarray,
                                                       jckpt.import_prior_checkpoint(path)))
    got = tckpt.import_prior_checkpoint(path)
    for part in ("brain", "prior"):
        assert_states_bit_equal(got[part], ref[part])
        assert_states_bit_equal(got[part], _as_np(tiny_prior_states[part]))


def test_prior_checkpoint_with_an_unknown_key_raises_in_both(tmp_path, tiny_prior_states):
    brain = dict(tiny_prior_states["brain"])
    brain["lin1X.weight"] = brain.pop("lin1.weight")
    path = reference_prior_pth(str(tmp_path / "bad.pth"), brain, tiny_prior_states["prior"])
    with pytest.raises(KeyError):
        jckpt.import_prior_checkpoint(path)
    with pytest.raises(KeyError):
        tckpt.import_prior_checkpoint(path)


# ------------------------------------------------------------- commands --


@pytest.fixture()
def vocab_dir(tmp_path, monkeypatch):
    """A CLIP vocab pair written by ``save_vocab_files`` (the packaged
    default vocab's tables), found through ``AVI_TALKING_CLIP_TOKENIZER``."""
    from avi_talking_tpu_torch.pipeline.generate import __file__ as gen_file
    import os

    default = os.path.join(os.path.dirname(os.path.dirname(gen_file)), "text", "default_vocab")
    tok = ClipBpeTokenizer.from_dir(default)
    merges = sorted(tok.ranks, key=tok.ranks.get)
    out = tmp_path / "vocab"
    save_vocab_files(tok.vocab, merges, out)
    monkeypatch.setenv("AVI_TALKING_CLIP_TOKENIZER", str(out))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    return out


def _write_wav(path, seconds, seed):
    rng = np.random.default_rng(seed)
    pcm = (rng.uniform(-0.3, 0.3, int(seconds * 16000)) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


def test_import_prior_then_generate_with_checkpoint(tmp_path, tiny_prior_states, vocab_dir):
    """The reference .pth -> ``import-prior`` -> ``generate --checkpoint``
    (twice: --bf16 as well) equals the direct API given the same states."""
    pth = reference_prior_pth(str(tmp_path / "last.pth"), **tiny_prior_states, ff_net=True)
    ck = tmp_path / "ck_prior"
    assert main(["import-prior", "--pth", pth, "--out", str(ck)]) == 0
    wav = tmp_path / "clip.wav"
    _write_wav(wav, 1.0, 0)
    for extra in ([], ["--bf16"]):
        out = tmp_path / f"out{len(extra)}"
        assert main(["generate", "--wav", str(wav), "--text", "a happy person", "--tiny",
                     "--device", "cpu", "--seed", "2", "--checkpoint", str(ck),
                     "--out", str(out), *extra]) == 0
        cfg = PipelineConfig.tiny()
        direct = AviTalkingPipeline.random_init(
            cfg, tassets.synthetic_assets(n_shape=8, n_exp=6), device="cpu",
            dtype=torch.bfloat16 if extra else torch.float32)
        direct.load_state_dict(tiny_prior_states)
        ref = direct.generate(str(wav), "a happy person", seed=2)
        got = np.load(out / "clip_coeffs.npz")
        for key in ("exp", "jaw", "style_emb"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_import_prior_without_a_vocab_refuses_as_jax_does(tmp_path, tiny_prior_states,
                                                          monkeypatch):
    from avi_talking_tpu import text as jtext
    from avi_talking_tpu.cli import main as jmain
    from avi_talking_tpu_torch import text as ttext

    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setattr(ttext, "find_tokenizer_assets", lambda *a: None)
    monkeypatch.setattr(jtext, "find_tokenizer_assets", lambda *a: None)
    pth = reference_prior_pth(str(tmp_path / "last.pth"), **tiny_prior_states)
    with pytest.raises(SystemExit, match="no CLIP tokenizer vocab"):
        jmain(["import-prior", "--pth", pth, "--out", str(tmp_path / "jax_ck")])
    with pytest.raises(SystemExit, match="no CLIP tokenizer vocab"):
        main(["import-prior", "--pth", pth, "--out", str(tmp_path / "ck")])
    assert (tmp_path / "ck" / "state.pt").exists()  # written first, as JAX writes it


def test_import_clip_vocab_and_weights(tmp_path, vocab_dir):
    """``import-clip`` validates and copies a vocab pair written by
    ``save_vocab_files``; ``--weights`` imports HF text weights too."""
    cfg = tclip.ClipTextConfig.tiny()
    st = _random_state(lambda: tclip.ClipTextModel(cfg), 6)
    torch.save({"text_model." + k: v for k, v in st.items()}, tmp_path / "clip.bin")
    dest = tmp_path / "dest"
    assert main(["import-clip", "--src", str(vocab_dir), "--dest", str(dest),
                 "--weights", str(tmp_path / "clip.bin"), "--out", str(tmp_path / "ck")]) == 0
    for fn in ("vocab.json", "merges.txt"):
        assert (dest / fn).read_bytes() == (vocab_dir / fn).read_bytes()
    validate_tokenizer_assets(dest)
    assert_states_bit_equal(tckpt.restore_checkpoint(str(tmp_path / "ck"))["clip"], _as_np(st))
    with pytest.raises(ValueError, match="specials"):
        bad = tmp_path / "bad"
        tok = ClipBpeTokenizer.from_dir(vocab_dir)
        vocab = dict(tok.vocab)
        vocab["<|startoftext|>"], vocab["<|endoftext|>"] = vocab["<|endoftext|>"], vocab[
            "<|startoftext|>"]
        save_vocab_files(vocab, sorted(tok.ranks, key=tok.ranks.get), bad)
        validate_tokenizer_assets(bad)


def test_save_load_bit_equal(tmp_path):
    cfg = PipelineConfig.tiny()
    a = AviTalkingPipeline.random_init(cfg, seed=1, device="cpu")
    a.save(str(tmp_path / "pipe"))
    b = AviTalkingPipeline.random_init(cfg, seed=2, device="cpu")
    b.load(str(tmp_path / "pipe"))
    for part, sd in a.state_dict().items():
        assert_states_bit_equal(b.state_dict()[part], _as_np(sd))
    wav = np.random.default_rng(0).uniform(-0.5, 0.5, 16000).astype(np.float32)
    ra, rb = a.generate(wav, "sad", seed=4), b.generate(wav, "sad", seed=4)
    for key in ("exp", "jaw", "style_emb"):
        np.testing.assert_array_equal(ra[key], rb[key])
    with pytest.raises(KeyError, match="parts"):
        b.load_state_dict({"unknown": {}})


def test_load_prior_checkpoint_after_training(tmp_path):
    """The prior trainer's checkpoint at the tiny pipeline's widths ->
    ``load_prior_checkpoint``: brain and prior equal the trained states."""
    from avi_talking_tpu_torch.train import driver

    pcfg = PipelineConfig.tiny()
    cfg = driver.PriorTrainingConfig(
        clip_size=pcfg.clip_size, in_dim=pcfg.clip.hidden_size, depth=pcfg.prior_depth,
        heads=pcfg.prior_heads, dim_head=pcfg.prior_dim_head, timesteps=pcfg.timesteps,
        total_steps=2, batch_size=4, log_every=100)
    res = driver.train_prior(cfg, batches=driver.synthetic_batches(4, 2, cfg.in_dim, cfg.clip_size),
                             ckpt_dir=str(tmp_path / "ck"), device=torch.device("cpu"))
    pipe = AviTalkingPipeline.random_init(pcfg, seed=3, device="cpu")
    pipe.load_prior_checkpoint(str(tmp_path / "ck"))
    assert_states_bit_equal(pipe.brain.state_dict(), _as_np(res["state"].brain.state_dict()))
    assert_states_bit_equal(pipe.prior.net.state_dict(),
                            _as_np(res["state"].prior.net.state_dict()))


def test_train_prior_with_tower_checkpoints(tmp_path, vocab_dir, capsys, monkeypatch):
    """``--emote-checkpoint`` (an import-emote checkpoint's style encoder)
    trains on the corpus; ``--pipeline-checkpoint`` requires the real CLIP
    tokenizer, which the tiny tower's 99 ids cannot hold (it refuses, as
    JAX's ``require_real`` does), and loads the checkpoint's CLIP tower."""
    from pathlib import Path

    from avi_talking_tpu_torch.cli.train_prior import build_featurizer
    from avi_talking_tpu_torch.pipeline import generate as tgen

    repo = Path(__file__).resolve().parents[1]
    clip_st = _random_state(lambda: tclip.ClipTextModel(tclip.ClipTextConfig.tiny()), 8)
    tckpt.save_checkpoint(str(tmp_path / "pipe"), {"clip": clip_st})
    tcfg = temote.EmoteConfig.tiny()
    sd = reference_emote_sd(tcfg, seed=9)
    n_cond = 9 + 3 + 32 + 8  # train-prior's condition width at --tiny
    sd["talking_head_model.sequence_decoder.obj_vector.map.weight"] = torch.randn(
        32, n_cond, generator=torch.Generator().manual_seed(9))
    torch.save({"state_dict": sd}, tmp_path / "emote.ckpt")
    assert main(["import-emote", "--ckpt", str(tmp_path / "emote.ckpt"), "--tiny",
                 "--out", str(tmp_path / "emote")]) == 0
    args = ["train-prior", "--tiny", "--device", "cpu", "--steps", "2", "--batch-size", "4",
            "--json-dir", str(repo / "experiments" / "json_dir"),
            "--wav-dir", str(repo / "experiments" / "wav_dir"),
            "--emote-checkpoint", str(tmp_path / "emote")]
    assert main(args) == 0
    out = capsys.readouterr()
    assert "final:" in out.out and "no --emote-checkpoint" not in out.err
    with pytest.raises(RuntimeError, match="exceeds the text tower's vocab_size"):
        main(args + ["--pipeline-checkpoint", str(tmp_path / "pipe")])

    monkeypatch.setattr(tgen, "load_tokenizer", lambda *a, **k: tgen._HashTokenizer(99, 16))
    feat = build_featurizer(True, 32, torch.device("cpu"), str(tmp_path / "pipe"),
                            str(tmp_path / "emote"))
    assert_states_bit_equal(feat.clip_model.state_dict(), _as_np(clip_st))
    np.testing.assert_array_equal(
        feat.style_encoder.map.weight.detach().numpy(),
        sd["talking_head_model.sequence_decoder.obj_vector.map.weight"].numpy())


# ---------------------------------------------------------- FLAME, stats --


def _flame_pickle(path, n_v=60, n_f=100, n_shape=400, n_pose=36, seed=0):
    """A FLAME 2020 pickle's arrays and types (J_regressor scipy sparse) at
    a reduced vertex count, and landmark embedding npys."""
    rng = np.random.default_rng(seed)
    m = {
        "v_template": rng.standard_normal((n_v, 3)),
        "shapedirs": rng.standard_normal((n_v, 3, n_shape)),
        "posedirs": rng.standard_normal((n_v, 3, n_pose)),
        "J_regressor": scipy.sparse.csc_matrix(rng.random((5, n_v)) * (rng.random((5, n_v)) > 0.7)),
        "weights": rng.random((n_v, 5)),
        "f": rng.integers(0, n_v, (n_f, 3)).astype(np.uint32),
        "kintree_table": np.array([[2 ** 32 - 1, 0, 1, 1, 1], [0, 1, 2, 3, 4]]),
        "bs_style": "lbs", "bs_type": "lrotmin",
    }
    with open(path, "wb") as f:
        pickle.dump(m, f, protocol=2)
    lmk = {"static_lmk_faces_idx": rng.integers(0, n_f, 51),
           "static_lmk_bary_coords": rng.random((51, 3)),
           "dynamic_lmk_faces_idx": rng.integers(0, n_f, (79, 17)),
           "dynamic_lmk_bary_coords": rng.random((79, 17, 3)),
           "full_lmk_faces_idx": rng.integers(0, n_f, (1, 68)),
           "full_lmk_bary_coords": rng.random((1, 68, 3))}
    lmk_path = str(path) + "_lmk.npy"
    np.save(lmk_path, lmk, allow_pickle=True)
    mp_path = str(path) + "_mp.npz"
    np.savez(mp_path, lmk_face_idx=rng.integers(0, n_f, 105), lmk_b_coords=rng.random((105, 3)))
    return lmk_path, mp_path


def test_convert_flame_matches_jax(tmp_path):
    pkl = tmp_path / "generic_model.pkl"
    lmk, mp = _flame_pickle(pkl)
    ref = jassets.convert_flame_pickle(str(pkl), str(tmp_path / "jax.npz"), lmk, mp)
    out = tmp_path / "assets" / "flame.npz"
    assert main(["convert-flame", "--pkl", str(pkl), "--out", str(out), "--lmk-embedding", lmk,
                 "--mediapipe-lmk-embedding", mp]) == 0
    a, b = np.load(ref), np.load(out)
    assert sorted(a.files) == sorted(b.files) and len(a.files) == 14
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assets = tassets.load_flame_assets(str(out), n_shape=100, n_exp=50)
    assert assets.shapedirs.shape == (60, 3, 150) and assets.faces.shape == (100, 3)


def test_stats_matches_jax(tmp_path, mead_root):  # noqa: F811
    import argparse

    jargs = argparse.Namespace(root=str(mead_root), max_clips=200,
                               mean_out=str(tmp_path / "jm.npy"), std_out=str(tmp_path / "js.npy"))
    assert jreconstruct.cmd_stats(jargs) == 0
    assert main(["stats", "--root", str(mead_root), "--mean-out", str(tmp_path / "m.npy"),
                 "--std-out", str(tmp_path / "s.npy")]) == 0
    for a, b in (("jm", "m"), ("js", "s")):
        np.testing.assert_array_equal(np.load(tmp_path / f"{b}.npy"),
                                      np.load(tmp_path / f"{a}.npy"))
