"""The sharded paths, each held against its unsharded run (port of
``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n, device="cpu")`` spawns ``n`` ranks (one torch thread
each, a ``FileStore`` rendezvous), builds the ("dp", "tp") mesh as JAX's
does (tp 2 where n is even and at least 4) and runs four cases at the tiny
configurations; every rank also runs each case unsharded and holds the
sharded result to it:

  1. the EMOTE geometric step under dp x tp, then under FSDP2 (tp rules
     first, then the dp split): losses, every gradient and weight, a
     q_proj shard that moves on every tp rank, a replicated gradient equal
     to the unsharded one (not tp times it, not zero);
  2. the diffusion-prior step under dp (global contrastive term);
  3. the EMOTE neural-loss step (renders and frozen towers) with condition
     exchange under dp x tp;
  4. ``AviTalkingPipeline.use_mesh`` ``generate_batch`` on dp + 1 clips.

The batches carry a frame mask whose valid counts differ by rank, so the
masked means must divide by the global count. ``inputs`` (a file written
by ``torch.save``) may carry carried weights, draws and noise in place of
the seeded ones, so a test can hold the results to another implementation.
The case functions also run in one process on a group of any size (the
card's check at full width)."""

from __future__ import annotations

import copy
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import (
    batch_sharding,
    dp_size,
    fsdp_shard_params,
    full_state_dict,
    whole,
    init_distributed,
    make_mesh,
    placements,
    shard_params,
    state_shardings_like,
)

LOSS_RTOL = 1e-5  # sharded against unsharded, relative
GRAD_TOL = 1e-5  # each gradient, of the model's largest gradient


def mesh_shape(n: int):
    """(dp, tp) as JAX's dry run lays n devices out."""
    tp = 2 if n % 2 == 0 and n >= 4 else 1
    return n // tp, tp


def _close(a: float, b: float, what: str, rtol: float = LOSS_RTOL) -> float:
    err = abs(a - b) / max(abs(a), 1e-12)
    if not (np.isfinite(a) and np.isfinite(b)) or err > rtol:
        raise AssertionError(f"{what}: sharded {b!r} against unsharded {a!r} (rel {err:.2e})")
    return err


def _named_trainables(module) -> Dict[str, torch.Tensor]:
    """The trainables of ``emote_trainables`` by name (parameters, then the
    BatchNorm statistics that JAX trains)."""
    from ..models.flint import RunningStatsBatchNorm1d

    out = dict(module.named_parameters())
    for name, mod in module.named_modules():
        if isinstance(mod, RunningStatsBatchNorm1d):
            out[name + ".running_mean"] = mod.running_mean
            out[name + ".running_var"] = mod.running_var
    return out


def hold_step(ref: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor], ref_w, got_w,
              lr: float, what: str) -> Dict[str, float]:
    """Gradients (by name) within ``GRAD_TOL`` of the largest, and weights by
    the 2·lr rule: a weight whose gradient rounds differently may take an
    AdamW step of up to lr either way, so two right steps differ by at most
    2·lr (+ rounding); the gradients are the sharp check."""
    gmax = max(float(g.abs().max()) for g in ref.values())
    gerr = max(float((whole(got[k]) - g).abs().max()) for k, g in ref.items())
    if gerr > GRAD_TOL * gmax:
        bad = max(ref, key=lambda k: float((whole(got[k]) - ref[k]).abs().max()))
        raise AssertionError(f"{what}: gradient of {bad} off by {gerr:.3e} "
                             f"(largest gradient {gmax:.3e})")
    werr = max(float((got_w[k] - v).abs().max()) for k, v in ref_w.items())
    if werr > 2 * lr + 1e-6:
        raise AssertionError(f"{what}: weights off by {werr:.3e} after one step of lr {lr}")
    return {"grad_err": gerr, "grad_max": gmax, "weight_err": werr}


def _launches() -> Dict[str, int]:
    """The kernels' launch counts (each wrapper adds one where it launches)."""
    from ..ops.kernels import keybias_attention as kb
    from ..ops.kernels import rasterize as kras

    return {"keybias_attention": kb.launches, "rasterize_tiles_visibility": kras.launches}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _launches().items()}


# --- batches ---------------------------------------------------------------------


def emote_batch(cfg, B: int, T: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """JAX's dry-run batch (8 expressions, 3 intensities, 32 identities,
    zero shape) with a frame mask: the first half of the rows whole, the
    second half valid over a shorter, row-dependent stretch."""
    rng = np.random.default_rng(seed)
    lens = np.where(np.arange(B) < B // 2, T, np.maximum(T - 3 - 5 * np.arange(B), 2))
    return {
        "raw_audio": rng.standard_normal((B, T, 640)).astype(np.float32),
        "expression": np.eye(8, dtype=np.float32)[rng.integers(0, 8, B)],
        "intensity": np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)],
        "identity": np.eye(32, dtype=np.float32)[rng.integers(0, 32, B)],
        "shape": np.zeros((B, cfg.n_shape), np.float32),
        "gt_exp": rng.standard_normal((B, T, cfg.flint.n_exp)).astype(np.float32) * 0.1,
        "gt_jaw": rng.standard_normal((B, T, 3)).astype(np.float32) * 0.05,
        "frame_mask": (np.arange(T)[None] < lens[:, None]).astype(np.float32),
    }


def prior_batch(B: int, in_dim: int, clip_size: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, in_dim)).astype(np.float32),
            rng.standard_normal((B, clip_size)).astype(np.float32))


def serve_wavs(n: int, samples: int = 8000, seed: int = 5):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.3, 0.3, samples).astype(np.float32) for _ in range(n)]


def _on(batch, device):
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


# --- the cases ---------------------------------------------------------------------


def build_emote_head(tiny: bool, device, state=None, flame_assets=None):
    """The dry run's head: condition 8 + 3 + 32 + n_shape, weights seeded 0
    or loaded from ``state``."""
    from ..infra.init import random_module
    from ..models.emote import EmoteConfig, EmoteTalkingHead

    cfg = EmoteConfig.tiny() if tiny else EmoteConfig()
    head = random_module(lambda: EmoteTalkingHead(cfg, condition_dim=8 + 3 + 32 + cfg.n_shape),
                         device, torch.Generator().manual_seed(0))
    if state is not None:
        head.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    head.flame_assets = None if flame_assets is None else flame_assets.to(device)
    return head


def _emote_step(head, batch, mesh, lr, neural=None, seed=None):
    from ..train.optim import adamw
    from ..train.talking_head import TalkingHeadTrainer, emote_trainables

    opt = adamw(emote_trainables(head), lr)
    trainer = TalkingHeadTrainer(head=head, optimizer=opt, neural=neural, mesh=mesh,
                                 disentangle="condition_exchange" if neural else None)
    rows = batch_sharding(mesh)
    gen = None if seed is None else torch.Generator(
        device=batch["raw_audio"].device).manual_seed(seed)
    metrics = trainer.train_step({k: rows(v) for k, v in batch.items()}, generator=gen)
    return {k: float(v) for k, v in metrics.items()}, opt


def _grads(head):
    return {k: t.grad.detach().clone() for k, t in _named_trainables(head).items()
            if t.grad is not None}


def case_emote(mesh, device, tiny: bool = True, B: Optional[int] = None, T: Optional[int] = None,
               lr: float = 1e-4, state=None, fsdp: bool = True, fsdp_min_size: int = 256
               ) -> Dict[str, Any]:
    """Case 1: the geometric step unsharded, under dp x tp and under FSDP2."""
    head0 = build_emote_head(tiny, device, state)
    cfg = head0.cfg
    B = B or 2 * dp_size(mesh)
    T = T or 2 * cfg.flint.latent_frame_size
    batch = _on(emote_batch(cfg, B, T), device)

    ref = copy.deepcopy(head0)
    m_ref, _ = _emote_step(ref, batch, None, lr)
    g_ref, w_ref = _grads(ref), ref.state_dict()

    tp_head = shard_params(copy.deepcopy(head0), mesh)
    q = tp_head.audio_encoder.encoder.layers[0].attention.q_proj.weight
    q0 = (q.to_local() if hasattr(q, "to_local") else q).detach().clone()
    before = _launches()
    m_tp, _ = _emote_step(tp_head, batch, mesh, lr)
    launches_tp = _since(before)
    q_local = (q.to_local() if hasattr(q, "to_local") else q).detach()
    out = {"B": B, "T": T, "loss": m_ref["loss"], "loss_tp": m_tp["loss"],
           "q_proj_shard": tuple(q_local.shape),
           "q_proj_moved": float((q_local - q0).abs().max()), "launches_tp": launches_tp}
    out["loss_tp_rel"] = _close(m_ref["loss"], m_tp["loss"], "emote dp x tp step")
    g_tp = _grads(tp_head)
    rep = "decoder.weight"  # replicated over tp: the whole gradient on every rank
    out["replicated_grad_ratio"] = float(
        whole(g_tp[rep]).norm() / g_ref[rep].norm())
    out["tp"] = hold_step(g_ref, g_tp, w_ref, full_state_dict(tp_head), lr, "emote dp x tp step")
    if out["q_proj_moved"] <= 0 or abs(out["replicated_grad_ratio"] - 1) > 1e-4:
        raise AssertionError(f"emote dp x tp step: {out}")
    out["state_tp"] = {k: v.cpu() for k, v in full_state_dict(tp_head).items()}
    if fsdp:
        f_head = fsdp_shard_params(copy.deepcopy(head0), mesh, min_size=fsdp_min_size)
        before = _launches()
        m_f, opt_f = _emote_step(f_head, batch, mesh, lr)
        out["launches_fsdp"] = _since(before)
        out["loss_fsdp"] = m_f["loss"]
        out["loss_fsdp_rel"] = _close(m_ref["loss"], m_f["loss"], "emote FSDP step")
        out["fsdp"] = hold_step(g_ref, _grads(f_head), w_ref, full_state_dict(f_head), lr,
                                "emote FSDP step")
        params = dict(f_head.named_parameters())
        st = state_shardings_like(opt_f, f_head)
        mism = [k for k, s in st.items() for v in s.values()
                if v != ("Replicate()",) and v != placements(params[k])]
        if mism:
            raise AssertionError(f"optimizer state placed unlike its parameter: {mism[:4]}")
        out["fsdp_placements"] = {k: placements(p) for k, p in params.items()
                                  if "layers.0." in k and "audio_encoder.encoder" in k}
    return out


def case_prior(mesh, device, B: Optional[int] = None, full: bool = False, lr: float = 1e-4,
               state=None, draws=None, batch=None) -> Dict[str, Any]:
    """Case 2: the diffusion-prior step under dp against the unsharded one
    (the same draws: given, or from one seeded generator)."""
    import dataclasses

    from ..train.driver import PriorTrainingConfig, build_state, step_generator
    from ..train.prior import PriorTrainer, step_draws
    from .mesh import draw_rows

    cfg = PriorTrainingConfig() if full else PriorTrainingConfig(
        clip_size=16, in_dim=24, depth=1, heads=2, dim_head=8, timesteps=5, brain_hidden=32)
    B = B or 2 * dp_size(mesh)

    def build():
        st = build_state(dataclasses.replace(cfg, max_lr=lr), 3, device)
        if state is not None:
            st.brain.load_state_dict({k: torch.as_tensor(v) for k, v in state["brain"].items()})
            st.prior.net.load_state_dict({k: torch.as_tensor(v)
                                          for k, v in state["prior"].items()})
        return st

    voxel, style = batch if batch is not None else prior_batch(B, cfg.in_dim, cfg.clip_size)
    voxel, style = torch.from_numpy(voxel).to(device), torch.from_numpy(style).to(device)
    ref = build()
    d = draws if draws is not None else step_draws(ref, B, step_generator(device, 0, 0))
    d = {k: ([t.to(device) for t in v] if isinstance(v, list) else
             None if v is None else v.to(device)) for k, v in d.items()}
    m_ref = PriorTrainer().train_step(ref, voxel, style, draws=d)
    g_ref = {k: p.grad.clone() for k, p in _prior_params(ref).items()}
    sh = build()
    rows = batch_sharding(mesh)
    m_dp = PriorTrainer(mesh=mesh).train_step(sh, rows(voxel), rows(style),
                                               draws=draw_rows(d, rows))
    out = {"B": B, "loss": float(m_ref["loss"]), "loss_dp": float(m_dp["loss"]),
           "metrics": {k: float(v) for k, v in m_dp.items()},
           "metrics_ref": {k: float(v) for k, v in m_ref.items()}}
    out["loss_dp_rel"] = _close(out["loss"], out["loss_dp"], "prior dp step")
    for k in ("loss_nce", "loss_prior"):
        _close(float(m_ref[k]), float(m_dp[k]), f"prior dp step {k}")
    if (m_ref["top1_fwd"], m_ref["top1_bwd"]) != (m_dp["top1_fwd"], m_dp["top1_bwd"]):
        raise AssertionError(f"prior dp step top-1: {m_dp} against {m_ref}")
    lr0 = sh.optimizer.schedule(0)
    out["dp"] = hold_step(g_ref, {k: p.grad for k, p in _prior_params(sh).items()},
                          _prior_weights(ref), _prior_weights(sh), lr0, "prior dp step")
    out["state_dp"] = {k: v.cpu() for k, v in _prior_weights(sh).items()}
    return out


def _prior_params(st):
    return {**{"brain." + k: p for k, p in st.brain.named_parameters()},
            **{"prior." + k: p for k, p in st.prior.net.named_parameters()}}


def _prior_weights(st):
    return {k: p.detach() for k, p in _prior_params(st).items()}


def case_neural(mesh, device, tiny: bool = True, B: Optional[int] = None,
                T: Optional[int] = None, lr: float = 1e-4) -> Dict[str, Any]:
    """Case 3: the neural-loss step with condition exchange under dp x tp."""
    from ..cli.train_emote import build_neural, neural_assets

    assets = neural_assets(tiny)
    neural = build_neural(tiny, assets.faces, device)
    head0 = build_emote_head(tiny, device, flame_assets=assets)
    cfg = head0.cfg
    B = B or 2 * dp_size(mesh)
    T = T or 2 * cfg.flint.latent_frame_size
    batch = _on(emote_batch(cfg, B, T, seed=3), device)
    ref = copy.deepcopy(head0)
    m_ref, _ = _emote_step(ref, batch, None, lr, neural, seed=11)
    g_ref, w_ref = _grads(ref), ref.state_dict()
    sh = shard_params(copy.deepcopy(head0), mesh)
    before = _launches()
    m_sh, _ = _emote_step(sh, batch, mesh, lr, neural, seed=11)
    out = {"B": B, "T": T, "loss": m_ref["loss"], "loss_sharded": m_sh["loss"],
           "launches_sharded": _since(before),
           "terms": sorted(k for k in m_sh if k.startswith("loss_"))}
    out["loss_rel"] = _close(m_ref["loss"], m_sh["loss"], "emote neural-loss dp x tp step")
    out["term_rel"] = {k: _close(m_ref[k], m_sh[k], f"emote neural-loss dp x tp step {k}")
                       for k in out["terms"]}
    out["dp_tp"] = hold_step(g_ref, _grads(sh), w_ref, full_state_dict(sh), lr,
                             "emote neural-loss dp x tp step")
    return out


def case_serve(mesh, device, tiny: bool = True, n_clips: Optional[int] = None, state=None,
               noise=None, samples: int = 8000, seed: int = 2, buckets=(32,),
               seconds=None, rtol: float = 1e-6) -> Dict[str, Any]:
    """Case 4: ``generate_batch`` under ``use_mesh`` on dp + 1 clips (not a
    dp multiple), or on clips of ``seconds``, against the unsharded
    pipeline."""
    from ..core.assets import synthetic_assets
    from ..pipeline.generate import AviTalkingPipeline, PipelineConfig

    cfg = PipelineConfig.tiny() if tiny else PipelineConfig()
    assets = synthetic_assets(n_shape=cfg.emote.n_shape, n_exp=cfg.emote.flint.n_exp)
    pipe = AviTalkingPipeline.random_init(cfg, assets, seed=0, device=device)
    if state is not None:
        pipe.load_state_dict(state)
    if seconds is not None:
        wavs = [serve_wavs(1, int(s * 16000), seed=10 + i)[0] for i, s in enumerate(seconds)]
    else:
        wavs = serve_wavs(n_clips or dp_size(mesh) + 1, samples)
    n = len(wavs)
    texts = ["a happy person speaks"] * n
    kw = dict(seed=seed, length_buckets=buckets, return_vertices=False, noise=noise)
    rep = pipe.generate_batch(wavs, texts, **kw)
    pipe.use_mesh(mesh)
    before = _launches()
    got = pipe.generate_batch(wavs, texts, **kw)
    launches = _since(before)
    err = max(float(np.abs(a[k] - b[k]).max()) for a, b in zip(rep, got) for k in ("exp", "jaw"))
    scale = max(float(np.abs(a[k]).max()) for a in rep for k in ("exp", "jaw"))
    if err > rtol * max(scale, 1.0):  # a row's GEMM rounds by the batch it sits in
        raise AssertionError(f"generate_batch under use_mesh: exp / jaw off by {err:.3e} "
                             f"(largest {scale:.3e})")
    return {"clips": n, "max_err": err, "largest": scale, "launches_sharded": launches,
            "outputs": [{k: o[k] for k in ("exp", "jaw", "style_emb")} for o in got]}


# --- the spawned run --------------------------------------------------------------------


CASES = {"emote": case_emote, "prior": case_prior, "neural": case_neural, "serve": case_serve}


def run_plan(mesh_of, device: str, plan, inputs: Dict[str, Any]) -> Dict[str, Any]:
    """Each (key, case, (dp, tp), kwargs) of ``plan`` on the mesh
    ``mesh_of(dp, tp)``; ``inputs[key]`` adds keyword arguments. Each result
    carries this rank's kernel launches over the case (the unsharded run's
    included) and, on the card, its peak memory."""
    res = {}
    for key, case, shape, kw in plan:
        before = _launches()
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        res[key] = CASES[case](mesh_of(*shape), device, **kw, **inputs.get(key, {}))
        res[key]["launches"] = _since(before)
        if device != "cpu":
            res[key]["peak_bytes"] = torch.cuda.max_memory_allocated()
    return res


def _rank_main(rank: int, n: int, device: str, backend: str, store_path: str, plan,
               inputs: Optional[str], out: str) -> None:
    import faulthandler

    faulthandler.enable()  # a rank killed by a signal prints where it was
    torch.set_num_threads(1)
    init_distributed(backend=backend, store=dist.FileStore(store_path, n), rank=rank,
                     world_size=n)
    try:
        if device != "cpu":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            device = f"cuda:{torch.cuda.current_device()}"
            # full float32, as the unsharded reference: TF32's rounding would
            # differ with each rank's batch size
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        ins = torch.load(inputs, weights_only=False) if inputs else {}
        res = run_plan(lambda dp, tp: make_mesh(dp, tp, "cpu" if device == "cpu" else "cuda"),
                       device, plan, ins)
        by_rank = [None] * n
        dist.all_gather_object(by_rank, {k: {f: v for f, v in r.items()
                                             if f.startswith("launches")
                                             or f in ("peak_bytes", "q_proj_moved")}
                                         for k, r in res.items()})
        res["by_rank"] = by_rank
        if rank == 0:
            torch.save(res, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(n: int, plan, device: str = "cpu", backend: Optional[str] = None,
              inputs: Optional[str] = None, workdir: Optional[str] = None) -> Dict[str, Any]:
    """Spawn ``n`` ranks (a FileStore rendezvous in a temporary directory;
    gloo on the CPU, NCCL on cards unless ``backend`` says otherwise), run
    ``plan`` (``run_plan``) on each, and return rank 0's results with every
    rank's launches and peak memory under "by_rank". A failed case raises
    here with the rank's traceback."""
    import torch.multiprocessing as mp

    backend = backend or ("gloo" if device == "cpu" else "nccl")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        out = os.path.join(tmp, "result.pt")
        mp.start_processes(_rank_main, nprocs=n, start_method="spawn",
                           args=(n, device, backend, os.path.join(tmp, "store"), plan, inputs,
                                 out))
        return torch.load(out, weights_only=False)


def dryrun_plan(n: int):
    """JAX's four dry-run cases at the tiny configurations on n ranks."""
    shape = mesh_shape(n)
    return [("case1", "emote", shape, {}), ("case2", "prior", shape, {}),
            ("case3", "neural", shape, {}), ("case4", "serve", shape, {})]


def dryrun_multichip(n: int, device: str = "cpu", inputs: Optional[str] = None,
                     workdir: Optional[str] = None) -> Dict[str, Any]:
    """The four cases on ``n`` spawned ranks (``run_ranks``), one line each;
    returns rank 0's results. ``inputs`` maps case keys to keyword arguments
    (carried weights, draws, noise)."""
    res = run_ranks(n, dryrun_plan(n), device, inputs=inputs, workdir=workdir)
    res["dp"], res["tp"] = mesh_shape(n)
    res["case1"]["q_proj_moved_by_rank"] = [r["case1"]["q_proj_moved"] for r in res["by_rank"]]
    c1, c2, c3, c4 = (res[f"case{i}"] for i in range(1, 5))
    print(f"dryrun[1] emote geometric step: dp x tp loss={c1['loss_tp']:.6f}, "
          f"fsdp loss={c1['loss_fsdp']:.6f}, unsharded {c1['loss']:.6f}")
    print(f"dryrun[2] prior train step: dp loss={c2['loss_dp']:.6f} == unsharded "
          f"{c2['loss']:.6f}")
    print(f"dryrun[3] emote neural-loss step (condition exchange): dp x tp "
          f"loss={c3['loss_sharded']:.6f} == unsharded {c3['loss']:.6f} (terms {c3['terms']})")
    print(f"dryrun[4] dp-sharded generate_batch: {c4['clips']} clips, max err "
          f"{c4['max_err']:.2e}")
    print(f"dryrun_multichip OK: mesh dp={res['dp']} tp={res['tp']}")
    return res


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
