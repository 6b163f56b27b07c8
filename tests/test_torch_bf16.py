"""Port parity at the product's ``--bf16`` compute dtype.

The JAX package builds its modules with ``dtype=jnp.bfloat16`` over float32
parameters; the port's ``dtype=torch.bfloat16`` does the same
(``ops.layers``). Each case runs the same weights and inputs through the
JAX module at float32 and at bfloat16, and through the port at bfloat16,
and holds the rule: the port's bfloat16 result is closer to JAX's bfloat16
result than JAX's bfloat16 result is to its float32 one (root mean square
distances, both in the assertion's message).

JAX's bfloat16 side is compiled with ``xla_allow_excess_precision`` off
(``exact_jit``), so every op rounds its result to bfloat16 as its dtype says,
as JAX's ops do one by one; by default XLA's CPU fusions keep float32 inside
a fusion, a compiler choice that eager torch ops cannot mirror. CLIP, the
prior net and the head's exp / jaw are bit-equal to JAX's bfloat16
(asserted). Elsewhere a long reduction sums in another float32 order and
rounds a few values the other way: the brain's 4096-deep dots (torch's CPU
GEMM; XLA's CPU dot gives the correctly rounded value there), wav2vec2's
convolutions, and float32 FLAME under the head's vertices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from avi_talking_tpu.audio import wav2vec2 as jw2v
from avi_talking_tpu.core import assets as jassets
from avi_talking_tpu.models import brain as jbrain
from avi_talking_tpu.models import clip_text as jclip
from avi_talking_tpu.models import emote as jemote
from avi_talking_tpu.models import prior_transformer as jprior
from avi_talking_tpu.models.diffusion import DiffusionPrior, NoiseScheduler
from avi_talking_tpu.ops.pallas.attention import fused_keybias_attention
from avi_talking_tpu.pipeline import generate as jgen
from avi_talking_tpu_torch.audio import wav2vec2 as tw2v
from avi_talking_tpu_torch.core import assets as tassets
from avi_talking_tpu_torch.infra import jax_params as jp
from avi_talking_tpu_torch.models import brain as tbrain
from avi_talking_tpu_torch.models import clip_text as tclip
from avi_talking_tpu_torch.models import emote as temote
from avi_talking_tpu_torch.models import prior_transformer as tprior
from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb
from avi_talking_tpu_torch.ops.layers import Linear
from avi_talking_tpu_torch.pipeline import generate as tgen
from _torch_threads import one_torch_thread  # noqa: F401

BF = jnp.bfloat16


def exact_jit(fn, *args, static_argnums=()):
    """``fn(*args)`` compiled with XLA's excess precision off."""
    compiled = jax.jit(fn, static_argnums=static_argnums).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*(a for i, a in enumerate(args) if i not in static_argnums))


def _rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def assert_closer(name, port, jax_bf16, jax_f32, equal=False):
    """The rule: rms(port - JAX bf16) < rms(JAX bf16 - JAX f32); with
    ``equal``, port and JAX bf16 bit-equal besides. Returns both distances."""
    port, jb, jf = _f32(port), _f32(jax_bf16), _f32(jax_f32)
    assert port.shape == jb.shape == jf.shape, name
    assert np.all(np.isfinite(port)), name
    if equal:
        np.testing.assert_array_equal(port, jb, err_msg=name)
    d_port, d_ref = _rms(port, jb), _rms(jb, jf)
    assert d_port < d_ref, (f"{name}: rms(port bf16 - JAX bf16) {d_port:.4g} is not below "
                            f"rms(JAX bf16 - JAX f32) {d_ref:.4g}")
    print(f"{name}: port-to-JAX-bf16 {d_port:.4g}, JAX bf16-to-f32 {d_ref:.4g}")
    return d_port, d_ref


def _load(module, state):
    module.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()}, strict=False)
    return module.eval()


# ----------------------------------------------------------------- K1 --


KB_CASES = [
    # B, H, T, S, d, valid key lengths per batch
    (2, 4, 24, 24, 16, (24, 9)),
    (1, 12, 37, 29, 64, (29,)),  # wav2vec2's head width, ragged
    (2, 2, 16, 40, 32, (40, 5)),  # T != S
]


@pytest.mark.parametrize("B,H,T,S,d,lens", KB_CASES)
def test_keybias_plain_bf16_matches_jax(B, H, T, S, d, lens):
    """K1's plain version on bfloat16 q, k, v and key bias against JAX's
    Pallas kernel in interpret mode and against wav2vec2's XLA path
    (scores at float32, softmax cast to bfloat16, bfloat16 P . V), each at
    bfloat16 and at float32 on the same bfloat16 values; the kernel route on
    CPU tensors takes the plain version and counts no launch."""
    rng = np.random.default_rng(B * 100 + T)
    q = jnp.asarray(rng.standard_normal((B, H, T, d)) * d ** -0.5, BF)
    k = jnp.asarray(rng.standard_normal((B, H, S, d)), BF)
    v = jnp.asarray(rng.standard_normal((B, H, S, d)), BF)
    bias = jnp.asarray(np.where(np.arange(S)[None] < np.asarray(lens)[:, None], 0.0, -1e9), BF)
    tq, tk, tv, tbias = (torch.from_numpy(_f32(a)).bfloat16() for a in (q, k, v, bias))
    kb.launches = kb.launches_bf16 = 0
    port = kb.keybias_attention(tq, tk, tv, tbias)
    assert port.dtype == torch.bfloat16 and kb.launches == kb.launches_bf16 == 0
    assert torch.equal(port, kb.keybias_attention_reference(tq, tk, tv, tbias))

    f32 = [a.astype(jnp.float32) for a in (q, k, v, bias)]
    assert_closer("pallas interpret", port, fused_keybias_attention(q, k, v, bias, interpret=True),
                  fused_keybias_attention(*f32, interpret=True))

    def xla(q, k, v, bias, dtype):
        s = jnp.einsum("bhtd,bhsd->bhts", q, k, preferred_element_type=jnp.float32)
        w = jax.nn.softmax(s + bias.astype(jnp.float32)[:, None, None, :], axis=-1)
        return jnp.einsum("bhts,bhsd->bhtd", w.astype(dtype), v)

    jb = exact_jit(xla, q, k, v, bias, BF, static_argnums=(4,))
    assert_closer("xla path", port, jb, xla(*f32, jnp.float32))


def _emulated_kernel(q, k, v, bias, variant):
    """K1 at bfloat16 computed another way on the CPU: ``reordered`` with
    the plain version's rounding points but its sums in float64 (what a
    correct kernel may differ by), ``one_pass`` rounding the unnormalised
    exponentials and dividing at the end, ``misnormalised`` with P 1% too
    large."""
    s = (torch.einsum("bhtd,bhsd->bhts", q.double(), k.double())
         + bias.double()[:, None, None, :]).float()
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l = e.double().sum(-1, keepdim=True).float()
    if variant == "one_pass":
        acc = torch.einsum("bhts,bhsd->bhtd", e.bfloat16().double(), v.double()).float()
        return (acc / l).bfloat16()
    p = (e / l * (1.01 if variant == "misnormalised" else 1.0)).bfloat16()
    return torch.einsum("bhts,bhsd->bhtd", p.double(), v.double()).float().bfloat16()


@pytest.mark.parametrize("variant,passes", [("reordered", True), ("one_pass", False),
                                            ("misnormalised", False)])
def test_bf16_kernel_limit_separates_a_wrong_kernel(variant, passes):
    """``kb.bf16_disagreement``, which holds the bfloat16 kernel to its
    plain version on the card, at the generate shape (B=1, H=12, T=S=200,
    d=64): a kernel that differs only in summation order passes; one that
    rounds the unnormalised exponentials, or mis-normalises P by 1%, fails."""
    g = torch.Generator().manual_seed(1)
    q = (torch.randn(1, 12, 200, 64, generator=g) * 64 ** -0.5).bfloat16()
    k = torch.randn(1, 12, 200, 64, generator=g).bfloat16()
    v = torch.randn(1, 12, 200, 64, generator=g).bfloat16()
    bias = torch.zeros(1, 200, dtype=torch.bfloat16)
    dis = kb.bf16_disagreement(_emulated_kernel(q, k, v, bias, variant),
                               kb.keybias_attention_reference(q, k, v, bias))
    assert (max(dis["worst"], dis["rms_worst"]) <= 1.0) == passes, dis


# ------------------------------------------------------------ modules --


@pytest.fixture(scope="module")
def j32():
    """The tiny JAX pipeline at float32 (its params, perturbed norms and
    statistics included, serve every case here), built once."""
    from test_torch_pipeline import _jax_pipeline

    return _jax_pipeline(jgen.PipelineConfig.tiny(), jassets.synthetic_assets(n_shape=8, n_exp=6))


def _params(pipe, part):
    return jax.tree.map(np.asarray, pipe.params[part])


@pytest.mark.parametrize("valid", [None, (12, 7)])
def test_wav2vec2_bf16(j32, valid):
    """With and without key padding: K1's bfloat16 route in every layer."""
    cfg = j32.cfg.emote.wav2vec2
    params = {"params": _params(j32, "head")["params"]["audio_encoder"]}
    port = _load(tw2v.Wav2Vec2Model(tw2v.Wav2Vec2Config.tiny(), dtype=torch.bfloat16),
                 jp.wav2vec2_state_from_jax(params["params"]))
    x = np.random.default_rng(2).uniform(-1, 1, (2, 3840)).astype(np.float32)
    kw = dict(output_len=12, valid_len=None if valid is None else np.asarray(valid))
    jf = exact_jit(lambda p, a: jw2v.Wav2Vec2Model(cfg).apply(p, a, **kw), params, x)
    jb = exact_jit(lambda p, a: jw2v.Wav2Vec2Model(cfg, dtype=BF).apply(p, a, **kw), params, x)
    vl = None if valid is None else torch.tensor(valid)
    with torch.no_grad():
        got = port(torch.from_numpy(x), output_len=12, valid_len=vl)
    assert got.dtype == torch.bfloat16
    assert_closer("wav2vec2", got, jb, jf)


def test_clip_text_bf16(j32):
    cfg, params = j32.cfg.clip, _params(j32, "clip")
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jf = exact_jit(jclip.ClipTextModel(cfg).apply, params, ids)
    jb = exact_jit(jclip.ClipTextModel(cfg, dtype=BF).apply, params, ids)
    port = _load(tclip.ClipTextModel(tclip.ClipTextConfig.tiny(), dtype=torch.bfloat16),
                 jp.clip_text_state_from_jax(params["params"]))
    with torch.no_grad():
        assert_closer("clip", port(torch.from_numpy(ids).long()), jb, jf, equal=True)


def test_brain_bf16(j32):
    """The pipeline's brain (hidden 4096) on the tiny text width."""
    kw = dict(out_dim=32, in_dim=32, clip_size=32)
    params = _params(j32, "brain")
    x = np.random.default_rng(4).standard_normal((2, 32)).astype(np.float32)
    jf = exact_jit(jbrain.BrainNetwork(**kw).apply, params, x)
    jb = exact_jit(jbrain.BrainNetwork(**kw, dtype=BF).apply, params, jnp.asarray(x, BF))
    port = _load(tbrain.BrainNetwork(**kw, dtype=torch.bfloat16),
                 jp.brain_state_from_jax(params["params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16())
    assert_closer("brain voxels", got[0], jb[0], jf[0])
    assert_closer("brain projector", got[1], jb[1], jf[1])


@pytest.mark.parametrize("cond_drop", [0.0, 1.0])
def test_prior_net_bf16(j32, cond_drop):
    """A float32 image embedding and a bfloat16 text embedding, as the
    sampler hands them; the conditional and the null pass."""
    c = j32.cfg
    kw = dict(dim=c.clip_size, depth=c.prior_depth, heads=c.prior_heads, dim_head=c.prior_dim_head)
    params = _params(j32, "prior")
    rng = np.random.default_rng(5)
    img = rng.standard_normal((2, 1, 32)).astype(np.float32)
    t = np.array([3, 7], np.int32)
    txt = jnp.asarray(rng.standard_normal((2, 32)), BF)
    drop = dict(brain_cond_drop_prob=cond_drop, image_cond_drop_prob=cond_drop)
    def net(dtype):
        return lambda p, *a: jprior.PriorTransformerNetwork(**kw, dtype=dtype).apply(
            p, *a, **drop)

    jf = exact_jit(net(jnp.float32), params, img, t, txt.astype(jnp.float32))
    jb = exact_jit(net(BF), params, img, t, txt)
    port = _load(tprior.PriorTransformerNetwork(**kw, dtype=torch.bfloat16),
                 jp.prior_state_from_jax(params["params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(img), torch.from_numpy(t),
                   torch.from_numpy(_f32(txt)).bfloat16(), **drop)
    assert_closer("prior net", got, jb, jf, equal=True)


def test_emote_head_bf16(j32):
    """The tiny head with FLAME: exp / jaw at bfloat16, vertices float32."""
    cfg, params, assets = j32.cfg.emote, _params(j32, "head"), j32.head.flame_assets
    rng = np.random.default_rng(6)
    audio = rng.uniform(-0.5, 0.5, (1, 16, 640)).astype(np.float32)
    style = rng.standard_normal((1, 32)).astype(np.float32)

    def head(dtype):
        module = jemote.EmoteTalkingHead(cfg, flame_assets=assets, dtype=dtype)
        return lambda p, a, st: module.apply(p, a, style_emb=st)

    jf = exact_jit(head(jnp.float32), params, audio, style)
    jb = exact_jit(head(BF), params, audio, style)
    port = _load(temote.EmoteTalkingHead(
        temote.EmoteConfig.tiny(), flame_assets=tassets.synthetic_assets(n_shape=8, n_exp=6),
        dtype=torch.bfloat16), jp.emote_head_state_from_jax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(audio), style_emb=torch.from_numpy(style))
    assert got["exp"].dtype == torch.bfloat16 and got["vertices"].dtype == torch.float32
    for key in ("exp", "jaw", "vertices"):  # vertices: float32 FLAME, another op order
        assert_closer(f"head {key}", got[key], jb[key], jf[key], equal=key != "vertices")


# ----------------------------------------------------------- generate --


def _correctly_rounded_dense(next_fun, args, kwargs, context):
    """A flax interceptor: the brain's Dense layers at bfloat16 with the dot
    summed in float64 and rounded once to bfloat16 (the correctly rounded
    dot), then the bias added at bfloat16 as flax does."""
    module = context.module
    if not (isinstance(module, nn.Dense) and isinstance(module.parent, jbrain.BrainNetwork)
            and context.method_name == "__call__"):
        return next_fun(*args, **kwargs)
    p = module.variables["params"]
    with jax.enable_x64(True):
        y = jnp.dot(args[0].astype(BF).astype(jnp.float64),
                    p["kernel"].astype(BF).astype(jnp.float64)).astype(BF)
    return y + p["bias"].astype(BF)


def _correctly_rounded_linear(layer):
    def forward(x):
        y = F.linear(x.to(torch.bfloat16).double(), layer.weight.to(torch.bfloat16).double())
        return y.bfloat16() + layer.bias.to(torch.bfloat16)
    return forward


def test_generate_bf16(j32):
    """The tiny pipeline's ``generate`` at bfloat16 with JAX's DDPM draws
    handed to the port, against JAX's pipeline at bfloat16 and float32 on
    the same weights, held per output on exp, jaw and vertices, and on the
    whole output (exp, jaw, style, vertices, each over its reference's rms,
    pooled).

    The style alone is held with the brain's dots correctly rounded on the
    port's side. torch's CPU bfloat16 GEMM sums the brain's 4096-deep dots
    in another float32 order and rounds a few of their values (about 3 in
    8192) the other way from the correctly rounded dot, which XLA's CPU dot
    gives here: JAX's style equals its style with every brain dot summed in
    float64 (asserted). After the prior's ten bfloat16 steps those one-step
    moves grow to the size of bfloat16's own rounding, so the port's style
    on its own GEMM is about as far from JAX's bfloat16 style as that is
    from the float32 one (both reported). With the brain's dots summed in
    float64 on the port's side too, the style holds the rule."""
    from test_torch_pipeline import INSTRUCTION, _ddpm_noise, _wav

    cfg, jassets_ = j32.cfg, j32.head.flame_assets
    net = jprior.PriorTransformerNetwork(dim=cfg.clip_size, depth=cfg.prior_depth,
                                         heads=cfg.prior_heads, dim_head=cfg.prior_dim_head,
                                         dtype=BF)
    jbf = jgen.AviTalkingPipeline(
        cfg=cfg, clip_model=jclip.ClipTextModel(cfg.clip, dtype=BF),
        brain=jbrain.BrainNetwork(out_dim=cfg.clip_size, in_dim=cfg.clip.hidden_size,
                                  clip_size=cfg.clip_size, dtype=BF),
        prior=DiffusionPrior(net=net, scheduler=NoiseScheduler.create(cfg.timesteps),
                             text_cond_drop_prob=cfg.cond_drop_prob,
                             image_cond_drop_prob=cfg.cond_drop_prob),
        head=jemote.EmoteTalkingHead(cfg.emote, flame_assets=jassets_, dtype=BF),
        params=j32.params, tokenizer=j32.tokenizer)
    port = tgen.AviTalkingPipeline.random_init(
        tgen.PipelineConfig.tiny(), tassets.synthetic_assets(n_shape=8, n_exp=6), device="cpu",
        dtype=torch.bfloat16)
    port.load_state_dict(jp.pipeline_state_from_jax(jax.tree.map(np.asarray, j32.params)))

    wav, seed = _wav(16000, 0), 3
    noise = _ddpm_noise(seed, (1, 1, cfg.clip_size), cfg.timesteps)
    ref32 = j32.generate(wav, INSTRUCTION, seed=seed)
    # jbf.generate, with its fused function compiled by exact_jit
    frames = jgen.frame_audio(wav, 16000, pad_to_multiple=cfg.emote.flint.latent_frame_size)
    audio = jnp.asarray(jgen.normalize_audio(frames)).reshape(1, *frames.shape)
    ids, key = jnp.asarray(jbf.tokenizer([INSTRUCTION])), jax.random.PRNGKey(seed)
    out = exact_jit(jbf._generate_fused_fn.__wrapped__, jbf.params, ids, audio, key,
                    1.0, "ddpm", 20, static_argnums=(4, 5, 6))
    refbf = {k: out[k][0] for k in ("exp", "jaw", "style_emb", "vertices")}
    got = port.generate(wav, INSTRUCTION, seed=seed, noise=noise)
    assert refbf["exp"].dtype == BF and got["exp"].dtype == np.float32
    for key_ in ("exp", "jaw", "vertices"):
        assert_closer(f"generate {key_}", got[key_], refbf[key_], ref32[key_])
    keys = ("exp", "jaw", "style_emb", "vertices")
    scale = {k: _rms(_f32(ref32[k]), 0.0) for k in keys}
    pooled = [np.concatenate([_f32(out[k]).ravel() / scale[k] for k in keys])
              for out in (got, refbf, ref32)]
    assert_closer("generate, whole output", *pooled)
    print(f"generate style_emb on torch's GEMM: port-to-JAX-bf16 "
          f"{_rms(got['style_emb'], _f32(refbf['style_emb'])):.4g}, "
          f"JAX bf16-to-f32 {_rms(_f32(refbf['style_emb']), ref32['style_emb']):.4g}")

    def style(params, ids, key):
        with nn.intercept_methods(_correctly_rounded_dense):
            return jbf._sample_style_fn.__wrapped__(params, ids, key, 1.0)

    np.testing.assert_array_equal(_f32(exact_jit(style, jbf.params, ids, key)[0]),
                                  _f32(refbf["style_emb"]))
    for layer in port.brain.modules():
        if isinstance(layer, Linear):
            layer.forward = _correctly_rounded_linear(layer)
    assert_closer("generate style_emb, brain dots correctly rounded",
                  port.sample_style(INSTRUCTION, noise=noise)[0], refbf["style_emb"],
                  ref32["style_emb"])
