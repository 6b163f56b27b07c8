"""The diffusion-prior and motion-prior training loops (port of
``train_prior`` and ``train_flint_vae`` in ``avi_talking_tpu/train/driver.py``).

Each batch holds ``voxel`` (B, 768) CLIP text means and ``style_target``
(B, 128) style embeddings, as numpy arrays or tensors (the caption corpus's
``data.prior_corpus.prior_corpus_batches``); ``synthetic_batches`` draws a
structured random stream (a codebook of styles, voxels their noisy
projections) with JAX's numpy calls. The NCE temperature is annealed by
``cosine_anneal``. With ``val_every`` the loop validates on a disjoint
stream (seed + 99,991), logs under ``prior_val/``, writes
``<ckpt_dir>/last`` ({"state", "best_val_loss"}) at every validation and
``<ckpt_dir>/best`` ({"params", "step"}) when the validation loss improves;
``resume`` continues from ``last``. Step i draws from a generator seeded by
(seed, i), so a resumed run draws what an unbroken one would.

``train_flint_vae`` trains FLINT (``models.flint_vae``) as a Gaussian VAE
or, with ``quantizer="vq"``, a VQ-VAE: AdamW over the parameters, the
BatchNorms in train mode (batch statistics, running statistics updated by
flax's rule and saved beside the parameters as ``batch_stats``).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..infra.checkpoint import restore_checkpoint, save_checkpoint
from ..infra.device import resolve_device
from ..infra.init import random_module
from ..infra.meters import Meter, ScalarWriter, write_metrics
from ..infra.run_dir import EarlyStopping, snapshot_config
from ..models.brain import BrainNetwork
from ..models.diffusion import DiffusionPrior, NoiseScheduler
from ..models.prior_transformer import PriorTransformerNetwork
from .losses import cosine_anneal
from .optim import adamw
from .prior import PriorTrainer, PriorTrainState, make_prior_optimizer

Batch = Dict[str, np.ndarray]


def synthetic_batches(batch_size: int, steps: int, in_dim: int = 768, style_dim: int = 128,
                      n_styles: int = 64, seed: int = 0) -> Iterator[Batch]:
    """Structured random (voxel, style) pairs: a fixed codebook of styles,
    voxels their noisy projections."""
    rng = np.random.default_rng(seed)
    styles = rng.standard_normal((n_styles, style_dim)).astype(np.float32)
    proj = rng.standard_normal((style_dim, in_dim)).astype(np.float32) / np.sqrt(style_dim)
    for _ in range(steps):
        idx = rng.integers(0, n_styles, batch_size)
        s = styles[idx]
        v = s @ proj + rng.standard_normal((batch_size, in_dim)).astype(np.float32) * 0.1
        yield {"voxel": v.astype(np.float32), "style_target": s}  # proj / sqrt(.) is float64


@dataclasses.dataclass
class PriorTrainingConfig:
    clip_size: int = 128
    in_dim: int = 768
    depth: int = 6
    heads: int = 8
    dim_head: int = 64
    timesteps: int = 100
    brain_hidden: int = 4096
    max_lr: float = 1e-4
    total_steps: int = 1000
    batch_size: int = 256
    log_every: int = 50
    nce_temp_start: float = 0.004
    nce_temp_end: float = 0.0075
    val_every: int = 0  # validate every N steps; 0 disables
    val_steps: int = 4  # batches per validation pass
    resume: bool = False  # restore <ckpt_dir>/last before training
    # stop after N validations in a row without improvement (0 = off)
    early_stop_patience: int = 0


def step_generator(device: torch.device, seed: int, i: int) -> torch.Generator:
    """The generator of training step i (validation batch j: i = 2**31 + j)."""
    return torch.Generator(device=device).manual_seed((seed << 32) + i)


def build_state(cfg: PriorTrainingConfig, seed: int, device: torch.device) -> PriorTrainState:
    """Seeded random brain and prior network with ``make_prior_optimizer``."""
    g = torch.Generator().manual_seed(seed)
    brain = random_module(lambda: BrainNetwork(out_dim=cfg.clip_size, in_dim=cfg.in_dim,
                                               clip_size=cfg.clip_size, hidden=cfg.brain_hidden),
                          device, g)
    net = random_module(lambda: PriorTransformerNetwork(dim=cfg.clip_size, depth=cfg.depth,
                                                        heads=cfg.heads, dim_head=cfg.dim_head),
                        device, g)
    prior = DiffusionPrior(net=net, scheduler=NoiseScheduler.create(cfg.timesteps))
    optimizer, _ = make_prior_optimizer(brain, prior, cfg.max_lr, cfg.total_steps)
    return PriorTrainState(brain=brain, prior=prior, optimizer=optimizer)


def train_prior(
    cfg: PriorTrainingConfig,
    batches: Optional[Iterator[Batch]] = None,
    logdir: Optional[str] = None,
    ckpt_dir: Optional[str] = None,
    seed: int = 0,
    val_batches: Optional[Callable[[], Iterator[Batch]]] = None,
    run_dir: Optional[str] = None,
    device=None,
) -> Dict[str, Any]:
    """Run the loop on the card (or ``device``); returns the final state,
    the last step's metrics, the validation history and the checkpoints."""
    device = resolve_device(device)
    if run_dir is not None:
        os.makedirs(run_dir, exist_ok=True)
        snapshot_config(run_dir, cfg)
        logdir = logdir or os.path.join(run_dir, "logs")
        ckpt_dir = ckpt_dir or os.path.join(run_dir, "checkpoints")
    if batches is None:
        batches = synthetic_batches(cfg.batch_size, cfg.total_steps, cfg.in_dim, cfg.clip_size,
                                    seed=seed)
    if val_batches is None and cfg.val_every:
        val_batches = lambda: synthetic_batches(  # noqa: E731
            cfg.batch_size, cfg.val_steps, cfg.in_dim, cfg.clip_size, seed=seed + 99_991)

    state = build_state(cfg, seed, device)
    trainer = PriorTrainer()
    best_val_loss = float("inf")
    last_dir = os.path.join(ckpt_dir, "last") if ckpt_dir else None
    best_dir = os.path.join(ckpt_dir, "best") if ckpt_dir else None
    if cfg.resume and last_dir and os.path.isdir(last_dir):
        restored = restore_checkpoint(last_dir, map_location=device)
        state.load_state_dict(restored["state"])
        best_val_loss = float(restored["best_val_loss"])
        print(f"resumed from {last_dir} at step {state.step} (best val loss {best_val_loss:.4f})")
    start_step = state.step
    temps = cosine_anneal(cfg.nce_temp_start, cfg.nce_temp_end, max(cfg.total_steps, 2)).tolist()

    def put(x) -> torch.Tensor:  # numpy, or a featurizer's tensor already on a device
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32)
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    def run_validation(step: int) -> Dict[str, float]:
        sums: Dict[str, float] = {}
        n = 0
        temp = temps[min(step, len(temps) - 1)]
        for j, vb in enumerate(val_batches()):
            m = trainer.eval_step(state, put(vb["voxel"]), put(vb["style_target"]), temp,
                                  generator=step_generator(device, seed, 2 ** 31 + j))
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in sums.items()}

    def params() -> Dict[str, Any]:
        return {"brain": state.brain.state_dict(), "prior": state.prior.net.state_dict()}

    writer = ScalarWriter(logdir) if logdir else None
    stopper = EarlyStopping(patience=cfg.early_stop_patience) if cfg.early_stop_patience else None
    metrics: Dict[str, Any] = {}
    val_history = []
    t0 = time.time()
    i = start_step
    try:
        for batch in batches:
            metrics = trainer.train_step(state, put(batch["voxel"]), put(batch["style_target"]),
                                         temps[min(i, len(temps) - 1)],
                                         generator=step_generator(device, seed, i))
            i += 1
            if i % cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                write_metrics(writer, m, i, prefix="prior/")
                print(f"step {i}: loss={m['loss']:.4f} nce={m['loss_nce']:.4f} "
                      f"prior={m['loss_prior']:.4f} top1={m['top1_fwd']:.3f} "
                      f"({(i - start_step) / (time.time() - t0):.1f} it/s)")
            if cfg.val_every and val_batches is not None and i % cfg.val_every == 0:
                val = run_validation(i)
                write_metrics(writer, val, i, prefix="prior_val/")
                improved = val["loss"] < best_val_loss
                best_val_loss = min(best_val_loss, val["loss"])
                if ckpt_dir:
                    if improved:
                        save_checkpoint(best_dir, {"params": params(), "step": state.step})
                    # "last" carries the best loss so far, so a resumed run keeps the tag honest
                    save_checkpoint(last_dir, {"state": state.state_dict(),
                                               "best_val_loss": best_val_loss})
                val_history.append({"step": i, **val})
                print(f"  val@{i}: loss={val['loss']:.4f} top1={val['top1_fwd']:.3f} "
                      f"(best {best_val_loss:.4f})")
                if stopper is not None and stopper.update(val["loss"]):
                    print(f"early stop at step {i} ({stopper.bad_evals} validations without "
                          f"improvement over {stopper.best:.4f})")
                    break
        if ckpt_dir and not cfg.val_every:
            save_checkpoint(ckpt_dir, {"params": params(), "step": state.step})
    finally:
        if writer is not None:
            writer.close()
    return {
        "state": state,
        "metrics": {k: float(v) for k, v in metrics.items()},
        "val_history": val_history,
        "best_val_loss": best_val_loss,
        "best_ckpt": best_dir if (ckpt_dir and cfg.val_every) else None,
        "last_ckpt": last_dir if (ckpt_dir and cfg.val_every) else ckpt_dir,
    }


def _batch_stats(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def train_flint_vae(
    motion_batches: Iterator[Any],
    total_steps: int,
    flint_cfg=None,
    lr: float = 1e-4,
    kl_weight: float = 0.01,
    logdir: Optional[str] = None,
    ckpt_dir: Optional[str] = None,
    seed: int = 0,
    quantizer: Optional[str] = None,  # None (Gaussian VAE) | "vq"
    codebook_size: int = 256,
    beta: float = 0.25,
    device=None,
    vae: Optional[torch.nn.Module] = None,
    noise: Optional[Callable[[int, tuple], torch.Tensor]] = None,
) -> Dict[str, Any]:
    """Motion-prior training on (B, T, out_dim) motion batches (numpy or
    tensors) for ``total_steps`` steps, on the card unless ``device`` says
    otherwise. ``vae`` (built with the same ``quantizer``) is trained in
    place of a seeded one; ``noise(step, shape)`` gives the VAE's sampling
    noise (a generator seeded ``seed`` on the device when None). Metrics are
    logged under ``flint/`` every 50 steps; ``ckpt_dir`` receives
    ``{"params", "batch_stats"}``. Returns the module, the last step's
    metrics, and the parameters and statistics."""
    from ..models.flint import FlintConfig
    from ..models.flint_vae import FlintVAE, FlintVQVAE

    device = resolve_device(device)
    if quantizer not in (None, "vq"):
        raise ValueError(f"unknown quantizer {quantizer!r}")
    cfg = flint_cfg or FlintConfig()
    if vae is None:
        vae = random_module((lambda: FlintVQVAE(cfg, codebook_size=codebook_size, beta=beta))
                            if quantizer else (lambda: FlintVAE(cfg)),
                            device, torch.Generator().manual_seed(seed))
    if noise is None:
        g = torch.Generator(device=device).manual_seed(seed)
        noise = lambda i, shape: torch.randn(shape, generator=g, device=device)  # noqa: E731
    optimizer = adamw(vae.parameters(), lr)
    vae.train()
    writer = ScalarWriter(logdir) if logdir else None
    metrics: Dict[str, torch.Tensor] = {}
    try:
        for i, motion in enumerate(itertools.islice(motion_batches, total_steps)):
            motion = torch.as_tensor(motion, dtype=torch.float32).to(device)
            if quantizer:
                loss, metrics = vae.loss(motion)
            else:
                loss, metrics = vae.loss(motion, noise(i, vae.latent_shape(motion.shape)),
                                         kl_weight)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            metrics = {k: v.detach() for k, v in metrics.items()}
            if writer is not None and (i + 1) % 50 == 0:
                for k, v in metrics.items():
                    meter = Meter("flint/" + k, writer)
                    meter.write(v)
                    meter.flush(i + 1)
    finally:
        if writer is not None:
            writer.close()
    vae.eval()
    params = {k: v.detach() for k, v in vae.named_parameters()}
    stats = _batch_stats(vae)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, {"params": params, "batch_stats": stats})
    return {"vae": vae, "params": params, "batch_stats": stats,
            "metrics": {k: float(v) for k, v in metrics.items()}}
