"""The product API: (wav, natural-language instruction) -> animated FLAME
face (port of ``avi_talking_tpu/pipeline/generate.py``).

    instruction --tokenize--> CLIP text tower --mean over tokens-->
    BrainNetwork --> 100-step DDPM prior (or DDIM) --> 128-d style
    wav --frame--> wav2vec2 --> EMOTE decoder (+style) --> FLINT -->
    exp (T, 50) + jaw (T, 3) --> FLAME --> vertices (T, 5023, 3)

Everything runs eagerly on ``pipeline.device`` (CUDA unless the caller
asked for the CPU); the only hand-written kernel on the path is the wav2vec2
key-bias attention. Host work: wav decode / framing and tokenization.
Outputs are numpy arrays, as in the JAX package.

``random_init(..., dtype=torch.bfloat16)`` is the product's ``--bf16``
mode: the modules compute in bfloat16 over float32 parameters (flax's
``dtype`` / ``param_dtype``, ``ops.layers``), the prior's sample is carried
in float32 and FLAME runs in float32. The outputs are float32 numpy arrays
holding the bfloat16 values (numpy has no bfloat16; JAX returns bfloat16
arrays).

Checkpoints (``save`` / ``load``) are the port's ``state.pt``
(``infra.checkpoint``): a dict of the parts ``clip``, ``brain``, ``prior``,
``head``, each a float32 state dict. The importers write the same layout
with the parts they have; ``load`` takes whatever parts a checkpoint holds.

Randomness: the prior's noise is drawn from a ``torch.Generator`` on the
pipeline's device seeded by ``seed``, or passed explicitly as
``noise={"init": (B, 1, D), "steps": (timesteps, B, 1, D)}`` ("steps" only
for DDPM) -- the way the tests feed both packages the same draws.

``use_mesh(mesh)`` serves data-parallel over the mesh's "dp" axis (every
rank holds the whole pipeline and runs its rows): ``sample_style`` and
``generate_batch`` pad the batch to a dp multiple by repeating its first
row, run this rank's rows and gather the outputs over dp in request order,
so they return what the unsharded pipeline returns. The prior's noise is
drawn for the unpadded global batch from the one seeded generator, then
padded and sliced: it depends on neither the rank nor the padding.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
import zlib
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..audio.frontend import frame_audio, normalize_audio, read_wav
from ..core.flame import FlameAssets, FlameModel
from ..data.batching import pad_to_bucket
from ..infra.checkpoint import restore_checkpoint, save_checkpoint
from ..infra.device import resolve_device
from ..infra.init import random_module
from ..models.brain import BrainNetwork
from ..models.clip_text import ClipTextConfig, ClipTextModel
from ..models.diffusion import DiffusionPrior, NoiseScheduler
from ..models.conditioning import EmotionStyleEncoder
from ..models.emote import EmoteConfig, EmoteTalkingHead
from ..models.prior_transformer import PriorTransformerNetwork
from ..ops.layers import set_compute_dtype
from ..parallel.mesh import batch_sharding, dp_gather, dp_size
from ..text import ClipBpeTokenizer, find_tokenizer_assets
from .postprocess import Intervals, apply_jaw_intervals


PIPELINE_PARTS = ("clip", "brain", "prior", "head")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    clip: ClipTextConfig = dataclasses.field(default_factory=ClipTextConfig)
    emote: EmoteConfig = dataclasses.field(default_factory=EmoteConfig)
    clip_size: int = 128
    prior_depth: int = 6
    prior_heads: int = 8  # clip_size // 16
    prior_dim_head: int = 64
    timesteps: int = 100
    cond_drop_prob: float = 0.2
    max_tokens: int = 77

    @classmethod
    def tiny(cls) -> "PipelineConfig":
        return cls(
            clip=ClipTextConfig.tiny(),
            emote=EmoteConfig.tiny(),
            clip_size=32,
            prior_depth=2,
            prior_heads=2,
            prior_dim_head=8,
            timesteps=10,
            max_tokens=16,
        )


class _HashTokenizer:
    """Deterministic whitespace + crc32 tokenizer, the last resort when no
    vocab.json / merges.txt pair exists anywhere. Fine for random weights,
    wrong for real CLIP weights."""

    def __init__(self, vocab_size: int, max_length: int):
        self.vocab_size = vocab_size
        self.max_length = max_length

    def __call__(self, texts):
        out = np.zeros((len(texts), self.max_length), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [1] + [2 + (zlib.crc32(w.encode()) % (self.vocab_size - 3))
                         for w in t.lower().split()]
            ids = ids[: self.max_length - 1] + [self.vocab_size - 1]
            out[i, : len(ids)] = ids
        return out


def _fold_ids(tokenize, vocab_size: int):
    """Fold out-of-range ids into the text tower's vocab (tiny configs with
    random weights, where ids are immaterial)."""
    return lambda texts: np.asarray(tokenize(texts)) % vocab_size


def load_tokenizer(vocab_size: int, max_length: int, *, assets_dir=None,
                   require_real: bool = False):
    """CLIP tokenizer resolution, in the JAX package's order:

    1. the offline BPE from a local vocab.json + merges.txt pair (explicit
       directory, ``AVI_TALKING_CLIP_TOKENIZER``, the repo's
       ``assets/clip_tokenizer/``, or the HF hub cache);
    2. (the JAX package's ``transformers`` step has no counterpart here);
    3. refuse when ``require_real``; else the packaged default vocab
       (``text/default_vocab``), ids folded into range when it is larger
       than the tower's vocab;
    4. the hash tokenizer, with a warning.
    """
    found = find_tokenizer_assets(assets_dir)
    if found is not None:
        tok = ClipBpeTokenizer.from_dir(found, max_length=max_length)
        if tok.vocab_size <= vocab_size:
            return tok
        if require_real:
            raise RuntimeError(
                f"CLIP tokenizer vocab ({tok.vocab_size}) exceeds the text "
                f"tower's vocab_size ({vocab_size}): tokenizer and model do not match.")
        return _fold_ids(tok, vocab_size)
    if require_real:
        raise RuntimeError(
            "No CLIP tokenizer vocab found. Real CLIP weights need the real BPE "
            "tokenizer: place vocab.json + merges.txt under assets/clip_tokenizer/ "
            "(or set AVI_TALKING_CLIP_TOKENIZER).")
    default_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "text", "default_vocab")
    if os.path.exists(os.path.join(default_dir, "vocab.json")):
        tok = ClipBpeTokenizer.from_dir(default_dir, max_length=max_length)
        if tok.vocab_size <= vocab_size:
            return tok
        return _fold_ids(tok, vocab_size)
    warnings.warn(
        "CLIP vocab not found: falling back to the hash tokenizer. Fine for "
        "random weights; WRONG for imported CLIP checkpoints.", stacklevel=2)
    return _HashTokenizer(vocab_size, max_length)


@dataclasses.dataclass
class AviTalkingPipeline:
    cfg: PipelineConfig
    clip_model: ClipTextModel
    brain: BrainNetwork
    prior: DiffusionPrior
    head: EmoteTalkingHead
    tokenizer: Any
    device: torch.device
    mesh: Any = None  # use_mesh: a ("dp", "tp") DeviceMesh

    @classmethod
    def random_init(
        cls,
        cfg: Optional[PipelineConfig] = None,
        flame_assets: Optional[FlameAssets] = None,
        seed: int = 0,
        device=None,
        dtype: torch.dtype = torch.float32,
    ) -> "AviTalkingPipeline":
        """Seeded random weights (one CPU generator, so the same seed gives
        the same weights on any device and at any ``dtype``, the compute
        dtype). ``device=None`` means CUDA and raises without a card; pass
        ``device="cpu"`` for the CPU."""
        device = resolve_device(device)
        cfg = cfg or PipelineConfig()
        g = torch.Generator().manual_seed(seed)
        clip_model = random_module(lambda: ClipTextModel(cfg.clip, dtype=dtype), device, g)
        brain = random_module(
            lambda: BrainNetwork(out_dim=cfg.clip_size, in_dim=cfg.clip.hidden_size,
                                 clip_size=cfg.clip_size, dtype=dtype), device, g)
        net = random_module(
            lambda: PriorTransformerNetwork(dim=cfg.clip_size, depth=cfg.prior_depth,
                                            heads=cfg.prior_heads,
                                            dim_head=cfg.prior_dim_head, dtype=dtype), device, g)
        prior = DiffusionPrior(net=net, scheduler=NoiseScheduler.create(cfg.timesteps))
        head = random_module(lambda: EmoteTalkingHead(cfg.emote, dtype=dtype), device, g)
        head.flame_assets = None if flame_assets is None else flame_assets.to(device)
        return cls(cfg=cfg, clip_model=clip_model, brain=brain, prior=prior, head=head,
                   tokenizer=load_tokenizer(cfg.clip.vocab_size, cfg.max_tokens),
                   device=device)

    def state_dict(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"clip": self.clip_model.state_dict(), "brain": self.brain.state_dict(),
                "prior": self.prior.net.state_dict(), "head": self.head.state_dict()}

    def load_state_dict(self, state: Mapping[str, Mapping[str, Any]]) -> None:
        """Load the parts of ``{"clip", "brain", "prior", "head"}`` that
        ``state`` holds (state dicts of tensors or numpy arrays, e.g. from
        ``infra.jax_params.pipeline_state_from_jax`` or an importer), each
        part whole; an unknown part raises. The head's style encoder may be
        absent: the generate path never runs it and a JAX head that never
        ran it has no weights for it."""
        unknown = sorted(set(state) - set(PIPELINE_PARTS))
        if unknown or not state:
            raise KeyError(f"pipeline state has parts {sorted(state)}; expected some of "
                           f"{list(PIPELINE_PARTS)}")

        def tensors(sd):
            return {k: torch.as_tensor(v) for k, v in sd.items()}

        for part, module in (("clip", self.clip_model), ("brain", self.brain),
                             ("prior", self.prior.net)):
            if part in state:
                module.load_state_dict(tensors(state[part]))
        if "head" in state:
            self._fit_style_encoder(state["head"])
            missing, unexpected = self.head.load_state_dict(tensors(state["head"]),
                                                            strict=False)
            missing = [k for k in missing if not k.startswith("style_encoder.")]
            if missing or unexpected:
                raise KeyError(f"head state: missing {missing}, unexpected {unexpected}")

    def _fit_style_encoder(self, head_state: Mapping[str, Any]) -> None:
        """Rebuild the head's style encoder at the condition width of
        ``head_state`` when that differs (flax infers the width from the
        condition it first sees; the generate path never runs the encoder,
        but its weights are kept so ``save`` writes them back)."""
        w = head_state.get("style_encoder.map.weight")
        enc = self.head.style_encoder
        if w is None or tuple(w.shape) == tuple(enc.map.weight.shape):
            return
        with torch.device("meta"):
            new = EmotionStyleEncoder(w.shape[1], w.shape[0],
                                      use_bias="style_encoder.map.bias" in head_state)
        set_compute_dtype(new, self.head.compute_dtype)
        self.head.style_encoder = new.to_empty(device=self.device).eval()

    def save(self, path: str) -> None:
        """Write every part's state to ``path/state.pt``."""
        save_checkpoint(path, self.state_dict())

    def load(self, path: str) -> None:
        """Load what ``save`` or an importer wrote (the parts it holds)."""
        self.load_state_dict(restore_checkpoint(path))

    def load_prior_checkpoint(self, path: str) -> None:
        """Graft a ``train-prior`` checkpoint (``{"params": {"brain",
        "prior"}, "step"}``) into this pipeline (train -> serve)."""
        params = restore_checkpoint(path)["params"]
        self.load_state_dict({"brain": params["brain"], "prior": params["prior"]})

    # ------------------------------------------------------------------

    def use_mesh(self, mesh) -> None:
        """Serve data-parallel over ``mesh``'s "dp" axis (see the module
        docstring); the weights stay whole on every rank."""
        self.mesh = mesh

    def _dp(self) -> int:
        return dp_size(self.mesh)

    def _local_rows(self, n: int) -> torch.Tensor:
        """Indices into a batch of ``n`` rows: padded to a dp multiple with
        the first row, then this rank's block."""
        idx = torch.arange(n + (-n) % self._dp())
        idx[n:] = 0
        return idx[batch_sharding(self.mesh).rows(idx.shape[0])]

    def _token_ids(self, texts) -> torch.Tensor:
        return torch.from_numpy(np.asarray(self.tokenizer(list(texts)), np.int64)).to(self.device)

    def _style(self, token_ids: torch.Tensor, seed: int, cond_scale: float,
               sampler: str = "ddpm", ddim_steps: int = 20,
               noise: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
        n = token_ids.shape[0]
        shape = (n, 1, self.cfg.clip_size)
        gen = init = steps = None
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        else:
            init = torch.tensor(np.asarray(noise["init"]), dtype=torch.float32)
            if noise.get("steps") is not None:
                steps = torch.tensor(np.asarray(noise["steps"]), dtype=torch.float32)
        if self.mesh is not None:
            if gen is not None:  # the loops' own draws, in their order, for all n rows
                init = torch.randn(shape, generator=gen, device=self.device)
                if sampler == "ddpm":
                    steps = torch.randn((self.cfg.timesteps, *shape), generator=gen,
                                        device=self.device)
                gen = None
            rows = self._local_rows(n)
            token_ids = token_ids[rows.to(token_ids.device)]
            init = init[rows.to(init.device)]
            steps = None if steps is None else steps[:, rows.to(steps.device)]
            shape = (rows.shape[0], *shape[1:])
        hidden = self.clip_model(token_ids)
        clip_voxels, _ = self.brain(hidden.mean(dim=1))
        if sampler == "ddim":
            style = self.prior.ddim_sample_loop(shape, clip_voxels, steps=ddim_steps,
                                                cond_scale=cond_scale, noise_init=init,
                                                generator=gen)
        elif sampler == "ddpm":
            style = self.prior.p_sample_loop(shape, clip_voxels, cond_scale=cond_scale,
                                             noise_init=init, noise_steps=steps,
                                             generator=gen)
        else:
            raise ValueError(f"unknown sampler {sampler!r}")
        return dp_gather(style[:, 0], self.mesh)[:n]

    @torch.inference_mode()
    def sample_style(self, instruction, seed: int = 0, cond_scale: float = 1.0,
                     noise: Optional[Mapping[str, Any]] = None) -> torch.Tensor:
        """(B, clip_size) style embeddings on the pipeline's device."""
        texts = [instruction] if isinstance(instruction, str) else list(instruction)
        return self._style(self._token_ids(texts), seed, cond_scale, noise=noise)

    @torch.inference_mode()
    def generate_batch(
        self,
        wavs: list,
        instructions: list,
        seed: int = 0,
        cond_scale: float = 1.0,
        length_buckets: tuple = (64, 128, 256, 512),
        sample_rate: int = 16_000,
        return_vertices: bool = True,
        stage_times: Optional[Dict[str, float]] = None,
        noise: Optional[Mapping[str, Any]] = None,
    ) -> list:
        """Batched serving: one style sampling over all requests, one head
        pass per length bucket. Buckets are rounded down to a multiple of the
        FLINT latent frame size; each clip is normalised, then zero-padded to
        its bucket, and ``valid_len`` masks the padding out of the wav2vec2
        attention keys (its conv group norm still sees the padded length, so
        results are close to, not bit-equal with, per-clip ``generate``).

        ``stage_times`` is filled with this call's host wall in ms:
        ``framing_ms``, ``style_dispatch_ms`` (tokenise + style sampling
        enqueue), ``prep_ms`` (bucket pad/stack + H2D + head enqueue) and
        ``device_fetch_ms`` (the blocking device-to-host copy, which waits
        for the device work)."""
        if len(wavs) != len(instructions):
            raise ValueError("need one instruction per wav")
        st = stage_times if stage_times is not None else {}
        lfs = self.cfg.emote.flint.latent_frame_size
        buckets = tuple(b - b % lfs for b in length_buckets)
        t0 = time.perf_counter()
        frames_list, lens = [], []
        for wav in wavs:
            sr = sample_rate
            if isinstance(wav, str):
                wav, sr = read_wav(wav)
            f = frame_audio(wav, sr, pad_to_multiple=lfs)
            lens.append(f.shape[0])
            frames_list.append(f)
        t1 = time.perf_counter()
        st["framing_ms"] = (t1 - t0) * 1e3

        styles = self._style(self._token_ids(instructions), seed, cond_scale, noise=noise)
        t2 = time.perf_counter()
        st["style_dispatch_ms"] = (t2 - t1) * 1e3
        st["prep_ms"] = st["device_fetch_ms"] = 0.0

        by_bucket: Dict[int, list] = {}
        for i, f in enumerate(frames_list):
            fitting = [b for b in buckets if f.shape[0] <= b]
            if not fitting:
                raise ValueError(
                    f"clip {i} has {f.shape[0]} frames, larger than the biggest "
                    f"length bucket {buckets[-1]}; pass bigger length_buckets")
            by_bucket.setdefault(fitting[0], []).append(i)
        results: list = [None] * len(wavs)
        for b, idxs in by_bucket.items():
            tb = time.perf_counter()
            # dp: this rank's rows of the bucket padded with its first clip
            local = [idxs[int(j)] for j in self._local_rows(len(idxs))]
            batch = np.stack([pad_to_bucket(normalize_audio(frames_list[i]).reshape(-1, 640),
                                            [b], axis=0) for i in local])
            vl = torch.tensor([lens[i] for i in local], device=self.device)
            out = self.head(torch.from_numpy(batch).to(self.device),
                            style_emb=styles[torch.tensor(local, device=self.device)],
                            valid_len=vl)
            out = {k: dp_gather(v, self.mesh)[:len(idxs)] for k, v in out.items()
                   if return_vertices or k != "vertices"}
            tf = time.perf_counter()
            st["prep_ms"] += (tf - tb) * 1e3
            host = {k: v.float().cpu().numpy() for k, v in out.items()}
            st["device_fetch_ms"] += (time.perf_counter() - tf) * 1e3
            for j, i in enumerate(idxs):
                T = lens[i]
                res = {"exp": host["exp"][j, :T], "jaw": host["jaw"][j, :T],
                       "style_emb": host["style_emb"][j], "frames": frames_list[i]}
                if "vertices" in host:
                    res["vertices"] = host["vertices"][j, :T]
                results[i] = res
        return results

    @torch.inference_mode()
    def generate(
        self,
        wav,
        instruction: str,
        seed: int = 0,
        cond_scale: float = 1.0,
        intervals: Optional[Intervals] = None,
        sample_rate: int = 16_000,
        sampler: str = "ddpm",  # "ddim" = faster style sampling
        ddim_steps: int = 20,
        noise: Optional[Mapping[str, Any]] = None,
    ) -> Dict[str, np.ndarray]:
        """wav (path or float array) + instruction -> exp / jaw / vertices."""
        if isinstance(wav, str):
            wav, sample_rate = read_wav(wav)
        lfs = self.cfg.emote.flint.latent_frame_size
        frames = frame_audio(wav, sample_rate, pad_to_multiple=lfs)
        audio = torch.from_numpy(normalize_audio(frames)).reshape(1, *frames.shape)
        style = self._style(self._token_ids([instruction]), seed, cond_scale,
                            sampler, ddim_steps, noise)
        out = self.head(audio.to(self.device), style_emb=style)

        exp, jaw = out["exp"], out["jaw"]
        if intervals is not None:
            exp, jaw = apply_jaw_intervals(exp, jaw, intervals)
            if self.head.flame_assets is not None:
                c = self.cfg.emote
                B, T = exp.shape[:2]
                flame = FlameModel(self.head.flame_assets, n_shape=c.n_shape, n_exp=c.n_exp)
                pose = torch.cat([torch.zeros_like(jaw), jaw], dim=-1)
                out["vertices"] = flame.vertices_only(
                    exp.new_zeros(B * T, c.n_shape, dtype=torch.float32),
                    exp.reshape(B * T, -1).float(),
                    pose.reshape(B * T, -1).float()).reshape(B, T, -1, 3)
        result = {"exp": exp[0].float().cpu().numpy(), "jaw": jaw[0].float().cpu().numpy(),
                  "style_emb": out["style_emb"][0].float().cpu().numpy(), "frames": frames}
        if "vertices" in out:
            result["vertices"] = out["vertices"][0].float().cpu().numpy()
        return result
