"""Port parity of the host codecs and the small product leftovers: the
native wav and PNG decoders (``native/{wavio,imageio}.cpp``, built by the
port at first use into ``build/avi_talking_tpu_torch/``), ``frame_audio_native``,
``load_audio_frames``, ``learn_bpe`` and the ``diversity`` command.

Limits: the 16 kHz wav decode within 1e-4 of JAX's Python ``read_wav``
(as ``tests/test_native.py``); a resampled decode (the native decoder
resamples linearly, the Python one polyphase) equal to JAX's own ctypes
binding over the same library, and a 440 Hz sine still one; framing, PNG
decodes, ``load_audio_frames`` and ``learn_bpe`` bit-equal; ``diversity``
within 1e-5 relative of JAX's score with JAX's prior draws handed in."""

import json
import struct
import wave
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest

from avi_talking_tpu.audio import frontend as jfront
from avi_talking_tpu.audio import native as jnative
from avi_talking_tpu.text import learn_bpe as jlearn_bpe
from avi_talking_tpu.train.eval_metrics import style_diversity as jstyle_diversity
from avi_talking_tpu.viz.pngio import _read_png_python as jread_png_python
from avi_talking_tpu_torch.audio import frontend as tfront
from avi_talking_tpu_torch.audio import native as tnative
from avi_talking_tpu_torch.cli import main
from avi_talking_tpu_torch.cli.run import diversity_score
from avi_talking_tpu_torch.infra import native_build
from avi_talking_tpu_torch.text import learn_bpe
from avi_talking_tpu_torch.viz import pngio
from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden"


def _write_wav(path, sr, data_f32):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((data_f32 * 32767).astype("<i2").tobytes())


def test_libraries_build_from_the_sources_into_build():
    """Both libraries come from ``native/*.cpp`` into the build directory,
    named by a hash of source and flags; a ``native/lib*.so`` is not read."""
    for name in ("wavio", "imageio"):
        lib = native_build.load(name)
        path = native_build.library_path(name)
        assert path.parent == native_build.BUILD_DIR and path.exists()
        assert lib._name == str(path)


def test_wav_decode_16k_matches_jax(tmp_path):
    data = np.random.default_rng(0).uniform(-0.8, 0.8, 16000).astype(np.float32)
    p = tmp_path / "a.wav"
    _write_wav(p, 16000, data)
    want, _ = jfront.read_wav(str(p))
    got, sr = tnative.read_wav_native(str(p))
    assert sr == 16000 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_wav_decode_resampled_48k_matches_jax_binding(tmp_path, monkeypatch):
    t = np.linspace(0, 1, 48000, endpoint=False)
    p = tmp_path / "b.wav"
    _write_wav(p, 48000, (np.sin(2 * np.pi * 440 * t) * 0.5).astype(np.float32))
    got, sr = tnative.read_wav_native(str(p))
    assert sr == 16000 and abs(len(got) - 16000) <= 2
    assert 0.3 < np.sqrt((got ** 2).mean()) < 0.4
    assert 800 < np.sum(np.diff(np.signbit(got))) < 960  # about 880 for 440 Hz over 1 s
    monkeypatch.setenv("AVI_TALKING_WAVIO", str(native_build.library_path("wavio")))
    monkeypatch.setattr(jnative, "_SEARCHED", False)
    monkeypatch.setattr(jnative, "_LIB", None)
    want, _ = jnative.read_wav_native(str(p))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [16000 * 3 + 123, 16000 * 30])  # the second cut at 22 s
def test_frame_audio_native_matches_frame_audio(n):
    wav = np.random.default_rng(1).uniform(-1, 1, n).astype(np.float32)
    got = tnative.frame_audio_native(wav)
    want = jfront.frame_audio(wav)
    assert got.shape == want.shape == (min(n, 22 * 16000) // 640, 640)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tfront.frame_audio(wav))


def test_load_audio_frames_matches_jax(tmp_path):
    data = np.random.default_rng(2).uniform(-0.5, 0.5, 16000 + 900).astype(np.float32)
    p = tmp_path / "c.wav"
    _write_wav(p, 16000, data)
    for pad in (1, 8):
        for got, want in zip(tfront.load_audio_frames(str(p), pad),
                             jfront.load_audio_frames(str(p), pad)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def _png(path, ctype, rows, plte=None):
    """A PNG of 8-bit ``rows`` (H, W * channels) with filter 0, or raw IDAT
    bytes when ``rows`` is bytes."""
    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    h, w = 2, 2
    raw = rows if isinstance(rows, bytes) else b"".join(b"\x00" + r.tobytes() for r in rows)
    body = [chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))]
    if plte is not None:
        body.append(chunk(b"PLTE", plte))
    body += [chunk(b"IDAT", zlib.compress(raw)), chunk(b"IEND", b"")]
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + b"".join(body))
    return str(path)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_native_roundtrip_matches_jax(tmp_path, channels):
    img = np.random.default_rng(channels).integers(0, 256, (23, 17, channels), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    pngio.write_png(p, img)
    got = pngio._read_png_native(p, pngio._load_native())
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jread_png_python(p))
    np.testing.assert_array_equal(pngio.read_png(p), got)


def test_png_native_all_filters_golden():
    """``golden/mixed_filters.png`` carries the five row filters (None, Sub,
    Up, Average, Paeth)."""
    p = str(GOLDEN / "mixed_filters.png")
    got = pngio._read_png_native(p, pngio._load_native())
    np.testing.assert_array_equal(got, np.load(GOLDEN / "mixed_filters_expected.npy"))
    np.testing.assert_array_equal(got, jread_png_python(p))
    np.testing.assert_array_equal(pngio._read_png_python(p), got)


def test_png_palette_goes_to_the_python_decoder(tmp_path):
    """The native decoder leaves palette images to Python (its code -3), as
    JAX's ``read_png`` does; the result is JAX's."""
    p = _png(tmp_path / "pal.png", 3, np.asarray([[0, 1], [2, 1]], np.uint8),
             plte=bytes([255, 0, 0, 0, 255, 0, 0, 0, 255]))
    with pytest.raises(ValueError, match=r"\(-3\)"):
        pngio._read_png_native(p, pngio._load_native())
    got = pngio.read_png(p)
    np.testing.assert_array_equal(got, jread_png_python(p))
    np.testing.assert_array_equal(got[0, 0], [255, 0, 0])


@pytest.mark.parametrize("case", ["not a png", "truncated", "bad deflate"])
def test_png_malformed_raises_as_jax(tmp_path, case):
    """The native decoder refuses a malformed file and ``read_png`` hands
    it to the Python decoder, as JAX's does: the same exception, with the
    same message, as JAX's Python decoder."""
    p = tmp_path / "bad.png"
    if case == "not a png":
        p.write_bytes(b"not a png at all")
    else:
        good = Path(_png(tmp_path / "g.png", 0, np.zeros((2, 2), np.uint8)))
        data = good.read_bytes()
        if case == "truncated":
            p.write_bytes(data[:40])
        else:  # the IDAT body overwritten: not a zlib stream
            i = data.index(b"IDAT") + 4
            p.write_bytes(data[:i] + b"\xff" * 6 + data[i + 6:])
    with pytest.raises(ValueError):
        pngio._read_png_native(str(p), pngio._load_native())
    with pytest.raises(Exception) as want:
        jread_png_python(str(p))
    with pytest.raises(Exception) as got:
        pngio.read_png(str(p))
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)


def test_learn_bpe_matches_jax():
    corpus = [json.loads(f.read_text())["output_texts"]
              for f in sorted((REPO / "experiments" / "json_dir").glob("*.json"))]
    vocab, merges = learn_bpe(corpus, num_merges=300)
    want_vocab, want_merges = jlearn_bpe(corpus, num_merges=300)
    assert len(merges) > 50 and merges == want_merges
    assert vocab == want_vocab


@pytest.fixture(scope="module")
def tiny_pipelines():
    """The style half of the tiny JAX pipeline (CLIP, brain, prior at
    ``random_init``'s keys; no head, which ``sample_style`` never runs) and
    the port's tiny pipeline with those three parts loaded."""
    import jax.numpy as jnp

    from avi_talking_tpu.models.brain import BrainNetwork
    from avi_talking_tpu.models.clip_text import ClipTextModel
    from avi_talking_tpu.models.diffusion import DiffusionPrior, NoiseScheduler
    from avi_talking_tpu.models.prior_transformer import PriorTransformerNetwork
    from avi_talking_tpu.pipeline import generate as jgen
    from avi_talking_tpu_torch.core import assets as tassets
    from avi_talking_tpu_torch.infra import jax_params
    from avi_talking_tpu_torch.pipeline import generate as tgen

    cfg = jgen.PipelineConfig.tiny()
    r_clip, r_brain, r_prior, _ = jax.random.split(jax.random.PRNGKey(0), 4)
    clip_model = ClipTextModel(cfg.clip)
    brain = BrainNetwork(out_dim=cfg.clip_size, in_dim=cfg.clip.hidden_size,
                         clip_size=cfg.clip_size)
    net = PriorTransformerNetwork(dim=cfg.clip_size, depth=cfg.prior_depth,
                                  heads=cfg.prior_heads, dim_head=cfg.prior_dim_head)
    params = {
        "clip": jax.jit(clip_model.init)(r_clip, jnp.zeros((1, cfg.max_tokens), jnp.int32)),
        "brain": jax.jit(brain.init)(r_brain, jnp.zeros((1, cfg.clip.hidden_size))),
        "prior": jax.jit(net.init)(r_prior, jnp.zeros((1, 1, cfg.clip_size)),
                                   jnp.zeros((1,), jnp.int32), jnp.zeros((1, cfg.clip_size))),
    }
    prior = DiffusionPrior(net=net, scheduler=NoiseScheduler.create(cfg.timesteps),
                           text_cond_drop_prob=cfg.cond_drop_prob,
                           image_cond_drop_prob=cfg.cond_drop_prob)
    jp = jgen.AviTalkingPipeline(cfg=cfg, clip_model=clip_model, brain=brain, prior=prior,
                                 head=None, params=params,
                                 tokenizer=jgen.load_tokenizer(cfg.clip.vocab_size,
                                                               cfg.max_tokens))
    tp = tgen.AviTalkingPipeline.random_init(
        tgen.PipelineConfig.tiny(), tassets.synthetic_assets(n_shape=8, n_exp=6), seed=5,
        device="cpu")
    host = jax.tree.map(np.asarray, params)
    tp.load_state_dict({
        "clip": jax_params.clip_text_state_from_jax(host["clip"]["params"]),
        "brain": jax_params.brain_state_from_jax(host["brain"]["params"]),
        "prior": jax_params.prior_state_from_jax(host["prior"]["params"])})
    return jp, tp


def test_diversity_matches_jax(tiny_pipelines):
    """JAX's ``diversity`` (sample i from PRNGKey(seed + i)) against
    ``diversity_score`` with those draws handed in, 4 samples."""
    from test_torch_style import jax_ddpm_noise

    jp, tp = tiny_pipelines
    text, n, seed = "a fairly angry man speaks with brow fairly down", 4, 3
    want = float(jstyle_diversity(np.stack([
        np.asarray(jp.sample_style(text, jax.random.PRNGKey(seed + i))[0]) for i in range(n)])))
    shape = (1, 1, tp.cfg.clip_size)
    noise = [dict(zip(("init", "steps"), jax_ddpm_noise(jax.random.PRNGKey(seed + i), shape,
                                                         tp.cfg.timesteps))) for i in range(n)]
    got = diversity_score(tp, text, n, seed, noise=noise)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got > 0


def test_cli_diversity_runs_on_cpu(capsys):
    """``diversity --tiny --device cpu``: the score of the CLI's pipeline
    (weights seed 0), sample i seeded --seed + i, as ``diversity_score``."""
    from avi_talking_tpu_torch.core.assets import synthetic_assets
    from avi_talking_tpu_torch.pipeline import AviTalkingPipeline, PipelineConfig

    assert main(["diversity", "--text", "a happy person", "--tiny", "--device", "cpu",
                 "--num-samples", "3", "--seed", "2"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("diversity over 3 samples: ")
    cfg = PipelineConfig.tiny()
    pipe = AviTalkingPipeline.random_init(
        cfg, synthetic_assets(n_shape=cfg.emote.n_shape, n_exp=cfg.emote.n_exp), device="cpu")
    assert line.endswith(f"{diversity_score(pipe, 'a happy person', 3, 2):.4f}")
