"""Staged EMOTE training loop: stages, validation, early stop, run
directories (port of ``avi_talking_tpu/train/emote_driver.py``).

Each stage gets a fresh AdamW (``optax.adamw(stage.lr)``'s settings over
``emote_trainables``) and its own loss configuration; the step count runs
on across stages. Every ``val_every`` steps the mean validation metrics
are logged, ``checkpoints/last`` is written and ``checkpoints/best`` when
the validation loss improved; ``EarlyStopping`` ends a stage early. The
head is trained in place (JAX copies its params at entry; here the
caller's module is the one that learns). Stages with ``use_neural`` add
the ``neural`` perceptual terms to their loss.

With ``mesh`` (JAX's ``mesh=``) the batches are global and each rank steps
on its own rows (``TalkingHeadTrainer``'s dp step); the head may already be
split over tp or FSDP (``parallel.shard_params`` / ``fsdp_shard_params``).
Only rank 0 logs and writes checkpoints, which hold whole tensors.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch

from ..infra.checkpoint import save_checkpoint
from ..infra.meters import ScalarWriter, write_metrics
from ..infra.run_dir import EarlyStopping, snapshot_config
from ..models.emote import EmoteTalkingHead
from ..parallel.mesh import batch_sharding, full_state_dict, is_main_process
from .optim import adamw
from .talking_head import NeuralLosses, TalkingHeadTrainer, emote_trainables

Batches = Callable[[], Iterator[Dict[str, torch.Tensor]]]


@dataclasses.dataclass
class EmoteStage:
    """One training stage: step budget + loss configuration."""

    name: str
    steps: int
    lr: float = 1e-4
    exp_weight: float = 1.0
    jaw_weight: float = 1.0
    vertex_weight: float = 1.0
    velocity_weight: float = 10.0
    use_neural: bool = False  # lip-reading / EmoNet / video-emotion terms
    disentangle: Optional[str] = None  # "condition_exchange" in stage 2


DEFAULT_STAGES = (
    EmoteStage(name="geometric", steps=1000),
    EmoteStage(name="perceptual", steps=1000, lr=5e-5, use_neural=True,
               disentangle="condition_exchange"),
)


def validate(trainer: TalkingHeadTrainer, val_batches: Batches, seed: int,
              device: torch.device) -> Dict[str, float]:
    """Mean metrics over ``val_batches()``; validation batch n draws its
    exchange from a generator seeded ``seed + 10**6 + n``, the same at
    every validation (JAX: ``fold_in(rng, 10**6 + n)``)."""
    sums: Dict[str, float] = {}
    n = 0
    rows = batch_sharding(trainer.mesh)
    for vb in val_batches():
        vb = {k: rows(v) for k, v in vb.items()}
        g = torch.Generator(device=device).manual_seed(seed + 10 ** 6 + n)
        for k, v in trainer.eval_step(vb, generator=g).items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}


def train_emote(
    head: EmoteTalkingHead,
    batches: Batches,
    stages: Sequence[EmoteStage] = DEFAULT_STAGES,
    neural: Optional[NeuralLosses] = None,
    val_batches: Optional[Batches] = None,
    val_every: int = 0,
    early_stop_patience: int = 0,
    run_dir: Optional[str] = None,
    log_every: int = 50,
    seed: int = 0,
    mesh=None,
) -> Dict[str, Any]:
    """Run the staged loop on ``head`` (in place); returns the per-stage
    validation histories, the best validation loss and the step count."""
    device = next(head.parameters()).device
    main = is_main_process()
    rows = batch_sharding(mesh)
    writer = None
    if run_dir is not None and main:
        os.makedirs(run_dir, exist_ok=True)
        snapshot_config(run_dir, {"stages": list(stages), "val_every": val_every})
        writer = ScalarWriter(os.path.join(run_dir, "logs"))
    gen = torch.Generator(device=device).manual_seed(seed)
    best_val = float("inf")
    histories: Dict[str, List[Dict[str, float]]] = {}
    step_total = 0
    try:
        for stage in stages:
            trainer = TalkingHeadTrainer(
                head=head, optimizer=adamw(emote_trainables(head), stage.lr),
                exp_weight=stage.exp_weight, jaw_weight=stage.jaw_weight,
                vertex_weight=stage.vertex_weight, velocity_weight=stage.velocity_weight,
                neural=neural if stage.use_neural else None, disentangle=stage.disentangle,
                mesh=mesh)
            stopper = EarlyStopping(patience=early_stop_patience) if early_stop_patience else None
            hist: List[Dict[str, float]] = []
            it = batches()
            t0 = time.time()
            for i in range(stage.steps):
                try:
                    batch = next(it)
                except StopIteration:
                    it = batches()
                    batch = next(it)
                metrics = trainer.train_step({k: rows(v) for k, v in batch.items()},
                                             generator=gen)
                step_total += 1
                if (i + 1) % log_every == 0 and main:
                    m = {k: float(v) for k, v in metrics.items()}
                    write_metrics(writer, m, step_total, prefix=f"emote/{stage.name}/")
                    print(f"[{stage.name}] step {i + 1}/{stage.steps}: loss={m['loss']:.4f} "
                          f"({(i + 1) / (time.time() - t0):.1f} it/s)")
                if val_every and val_batches is not None and (i + 1) % val_every == 0:
                    val = validate(trainer, val_batches, seed, device)
                    write_metrics(writer, val, step_total, prefix=f"emote_val/{stage.name}/")
                    hist.append({"step": step_total, **val})
                    params = full_state_dict(head) if run_dir else None
                    if run_dir and main:
                        state = {"params": params, "step": step_total}
                        if val["loss"] < best_val:
                            save_checkpoint(os.path.join(run_dir, "checkpoints", "best"), state)
                        save_checkpoint(os.path.join(run_dir, "checkpoints", "last"), state)
                    best_val = min(best_val, val["loss"])
                    if stopper is not None and stopper.update(val["loss"]):
                        if main:
                            print(f"[{stage.name}] early stop at step {i + 1}")
                        break
            histories[stage.name] = hist
    finally:
        if writer is not None:
            writer.close()
    return {"histories": histories, "best_val": best_val, "total_steps": step_total}
