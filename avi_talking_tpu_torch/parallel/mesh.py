"""Device mesh, batch split and parameter sharding on ``torch.distributed``
(port of ``avi_talking_tpu/parallel/mesh.py``).

One ``DeviceMesh`` with the axes ("dp", "tp") over the process group:

  * "dp": each rank runs its own rows of the global batch
    (``batch_sharding``); gradients are averaged over the dp group only
    (``reduce_gradients``), or reduce-scattered by FSDP2
    (``fsdp_shard_params``). JAX's GSPMD computes the global-batch
    function; the trainers keep that meaning by drawing their random
    numbers for the global batch and slicing them, and by taking the
    batch-wise terms (masked means' counts, the prior's contrastive loss,
    condition exchange) over the dp group (``dp_sum``, ``dp_gather``);
  * "tp": wav2vec2's Megatron split, q / k / v / intermediate column-wise
    and out / output row-wise (``emote_param_sharding_rules``), applied by
    ``parallelize_module``; each rank's attention runs on its own heads;
  * more than one process: ``init_distributed`` (NCCL on the card, gloo on
    the CPU), started by ``torch.distributed.run``.

Only rank 0 logs and writes checkpoints (``is_main_process``), as JAX's
``process_index() == 0``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``; the functions
that take ``mesh=None`` treat it as one process holding the whole batch.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

Spec = Tuple[Optional[str], ...]  # JAX's PartitionSpec as a tuple: a mesh axis or None a dim


def init_distributed(coordinator: Optional[str] = None, backend: Optional[str] = None, *,
                     device: Optional[str] = None, store: Optional[dist.Store] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None) -> bool:
    """Start the process group when there is more than one process
    (``WORLD_SIZE`` > 1, as ``torch.distributed.run`` sets), a
    ``coordinator`` ("host:port") or a ``store`` is given; otherwise a
    no-op, as JAX's. ``backend`` defaults to NCCL, or gloo for
    ``device="cpu"``; on the card each process takes the card
    ``LOCAL_RANK``. Returns whether a group is up."""
    if dist.is_initialized():
        return True
    world = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", 1))
    if world <= 1 and coordinator is None and store is None:
        return False
    backend = backend or ("gloo" if device == "cpu" else "nccl")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kw: Dict[str, Any] = {"backend": backend, "timeout": datetime.timedelta(seconds=300)}
    if store is not None:
        kw.update(store=store, rank=rank, world_size=world)
    elif coordinator is not None:
        kw.update(init_method=f"tcp://{coordinator}",
                  rank=int(rank if rank is not None else os.environ.get("RANK", 0)),
                  world_size=world)
    dist.init_process_group(**kw)
    return True


def is_main_process() -> bool:
    """Rank 0, or no process group (JAX's ``process_index() == 0``)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(dp: Optional[int] = None, tp: int = 1, device_type: Optional[str] = None):
    """("dp", "tp") ``DeviceMesh`` over the process group; dp defaults to
    world // tp and tp is the inner axis (its ranks are neighbours).
    ``device_type`` defaults to "cuda" under NCCL and "cpu" otherwise."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None:
        dp = n // tp
    assert dp * tp == n, f"dp({dp}) * tp({tp}) != devices({n})"
    if device_type is None:
        device_type = "cuda" if dist.is_initialized() and dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))


# --- the batch split ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """This rank's block of rows of a global batch: ``size`` equal blocks,
    block ``rank``. ``size`` 1 is the replicated placement."""

    rank: int = 0
    size: int = 1

    def rows(self, n: int) -> slice:
        if n % self.size:
            raise ValueError(f"a global batch of {n} rows does not split over dp={self.size}")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def __call__(self, x):
        """Rows of an array or tensor with a leading batch dim; other leaves
        (scalars, strings, 0-d arrays) as they are."""
        if getattr(x, "ndim", 0) < 1:
            return x
        return x[self.rows(x.shape[0])]


def dp_size(mesh) -> int:
    return 1 if mesh is None else mesh["dp"].size()


def batch_sharding(mesh, leading_axis: str = "dp") -> BatchSharding:
    """The batch split over ``leading_axis`` (JAX's ``P("dp")``)."""
    if mesh is None:
        return BatchSharding()
    sub = mesh[leading_axis]
    return BatchSharding(sub.get_local_rank(), sub.size())


def replicate(mesh) -> BatchSharding:
    """The replicated placement (JAX's ``P()``): every rank holds it all."""
    return BatchSharding()


# --- collectives over dp -----------------------------------------------------


def dp_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the dp group (a new tensor, outside autograd)."""
    x = x.detach().clone()
    if dp_size(mesh) > 1:
        dist.all_reduce(x, group=mesh["dp"].get_group())
    return x


def dp_mean(metrics: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Each scalar metric averaged over the dp group, in one all-reduce."""
    if dp_size(mesh) <= 1 or not metrics:
        return metrics
    keys = list(metrics)  # every rank builds its metrics in the same order
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=mesh["dp"].get_group())
    flat = flat / dp_size(mesh)
    return dict(zip(keys, flat.unbind()))


class _Gather(torch.autograd.Function):
    """The dp blocks of a batch gathered through one all-reduce of a zeroed
    buffer that holds this rank's block; the backward all-reduces the
    gradient and keeps this rank's block (a reduce-scatter of the sum).
    All-reduce is the collective every backend runs on CUDA tensors, gloo
    included, so one path serves NCCL and the two-process check on one
    card."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rows = group, slice(rank * x.shape[0], (rank + 1) * x.shape[0])
        buf = x.new_zeros((size * x.shape[0], *x.shape[1:]))
        buf[ctx.rows] = x
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rows], None, None, None


def dp_gather(x: torch.Tensor, mesh, grad: bool = False) -> torch.Tensor:
    """The global batch from each rank's equal block of rows, in rank order.
    With ``grad`` the gather is differentiable: its backward sums the
    gradients of every rank's copy, so a loss that each rank computes alike
    over the gathered batch gets, after ``reduce_gradients`` averages, the
    unsharded gradient."""
    if dp_size(mesh) <= 1:
        return x
    sub = mesh["dp"]
    return _Gather.apply(x if grad else x.detach(), sub.get_group(), sub.get_local_rank(),
                         sub.size())


def _fsdp_managed(t: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor) and "dp" in (t.device_mesh.mesh_dim_names or ())


def reduce_gradients(tensors: Iterable[torch.Tensor], mesh) -> None:
    """Average the gradients of ``tensors`` over the dp group in place, one
    all-reduce per dtype (a tp-sharded weight's local shard is reduced with
    its dp peers only: reducing over the whole world would mix shards, or
    count a tp-replicated gradient tp times). FSDP2's own parameters are
    skipped: its reduce-scatter has averaged them."""
    if dp_size(mesh) <= 1:
        return
    grads: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        if t.grad is None or _fsdp_managed(t):
            continue
        g = t.grad.to_local() if hasattr(t.grad, "to_local") else t.grad
        grads.setdefault(g.dtype, []).append(g)
    group = mesh["dp"].get_group()
    for gs in grads.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=group)
        flat /= dp_size(mesh)
        parts = flat.split([g.numel() for g in gs])
        torch._foreach_copy_(gs, [f.view_as(g) for f, g in zip(parts, gs)])


# --- parameter sharding rules ---------------------------------------------------

_LAYER = r"audio_encoder\.encoder\.layers\.\d+\."
_TP_COL = [_LAYER + m for m in (r"attention\.q_proj", r"attention\.k_proj", r"attention\.v_proj",
                                r"feed_forward\.intermediate_dense")]
_TP_ROW = [_LAYER + m for m in (r"attention\.out_proj", r"feed_forward\.output_dense")]


def emote_param_sharding_rules(name: str) -> Spec:
    """Megatron tensor parallelism of the EMOTE head's wav2vec2 encoder, on
    the port's state-dict names: column-parallel weights split their output
    features, row-parallel ones their input features, and a column layer's
    bias goes with its outputs; everything else is replicated. A torch
    weight is (out, in), the transpose of flax's kernel, so JAX's column
    ``P(None, "tp")`` is ``("tp", None)`` here and its row ``P("tp", None)``
    is ``(None, "tp")``."""
    for pat in _TP_COL:
        if re.search(pat + r"\.weight$", name):
            return ("tp", None)
        if re.search(pat + r"\.bias$", name):
            return ("tp",)
    for pat in _TP_ROW:
        if re.search(pat + r"\.weight$", name):
            return (None, "tp")
    return ()


def param_shardings(module: nn.Module, rules=emote_param_sharding_rules) -> Dict[str, Spec]:
    """Each parameter's spec under ``rules`` (what ``shard_params`` does)."""
    return {name: rules(name) for name, _ in module.named_parameters()}


def tp_plan(module: nn.Module, rules=emote_param_sharding_rules) -> Dict[str, Any]:
    """``parallelize_module``'s plan from the weight rules: a Linear whose
    weight splits its outputs is column-parallel, its inputs row-parallel.
    Both hand plain local tensors on (``use_local_output``): the attention
    kernel sees each rank's own heads. Every rank must hold the same whole
    weights before the split (seeded or loaded alike)."""
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    plan = {}
    for name, mod in module.named_modules():
        if isinstance(mod, nn.Linear):
            spec = rules(name + ".weight")
            style = {("tp", None): ColwiseParallel, (None, "tp"): RowwiseParallel}.get(spec)
            if style is not None:
                plan[name] = style(use_local_output=True)
                # every rank holds the same weights: each takes its slice, no scatter
                plan[name].src_data_rank = None
    return plan


def shard_params(module: nn.Module, mesh, rules=emote_param_sharding_rules) -> nn.Module:
    """Split ``module``'s parameters over the mesh's "tp" axis in place
    (``parallelize_module``); a no-op at tp = 1."""
    if mesh is None or mesh["tp"].size() == 1:
        return module
    from torch.distributed.tensor.parallel import parallelize_module

    return parallelize_module(module, mesh["tp"], tp_plan(module, rules))


# --- FSDP (ZeRO-3) ----------------------------------------------------------------


def fsdp_extend_spec(spec: Spec, shape: Sequence[int], n: int, axis: str = "dp",
                     min_size: int = 8192) -> Spec:
    """``spec`` with the largest still-unsharded dim of ``shape`` split over
    ``axis`` of size ``n``, where it divides; only 2-D leaves of at least
    ``min_size`` elements (matmul weights and embedding tables, where the
    bytes are) are split. JAX's rule, on shapes alone."""
    size = int(np.prod(shape)) if len(shape) else 0
    if size < min_size or n <= 1 or len(shape) != 2:
        return tuple(spec)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if axis in {e for e in entries if e is not None}:
        return tuple(spec)
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if entries[d] is None and shape[d] % n == 0 and shape[d] >= n:
            entries[d] = axis
            return tuple(entries)
    return tuple(spec)


def fsdp_param_shardings(module: nn.Module, mesh, rules=emote_param_sharding_rules,
                         axis: str = "dp", min_size: int = 8192) -> Dict[str, Spec]:
    """Each parameter's spec: the tp rules first, then FSDP over ``axis``
    on the torch weight's shape."""
    n = dp_size(mesh) if axis == "dp" else mesh[axis].size()
    return {name: fsdp_extend_spec(rules(name), tuple(p.shape), n, axis, min_size)
            for name, p in module.named_parameters()}


def fsdp_shard_params(module: nn.Module, mesh, rules=emote_param_sharding_rules,
                      axis: str = "dp", min_size: int = 8192) -> nn.Module:
    """``shard_params`` over tp, then FSDP2's ``fully_shard`` over
    ``mesh[axis]`` with each weight split on the dim that
    ``fsdp_param_shardings`` gives. FSDP2 cannot leave a parameter whole:
    the ones the rule keeps whole (small, or not 2-D) are split on dim 0,
    padded where uneven, which changes their layout only."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    specs = fsdp_param_shardings(module, mesh, rules, axis, min_size)
    shard_params(module, mesh, rules)  # new Parameter objects: look them up after
    by_id = {id(p): specs[name] for name, p in module.named_parameters()}

    def placement(param):
        spec = by_id.get(id(param), ())
        return Shard(spec.index(axis)) if axis in spec else Shard(0)

    fully_shard(module, mesh=mesh[axis], shard_placement_fn=placement)
    return module


def placements(t: torch.Tensor) -> Tuple[str, ...]:
    """A tensor's placements over its mesh (("Replicate",) for a plain
    tensor), by name."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return ("Replicate()",)
    return tuple(str(p) for p in t.placements)


def state_shardings_like(optimizer: torch.optim.Optimizer, module: nn.Module
                         ) -> Dict[str, Dict[str, Tuple[str, ...]]]:
    """The placements of the optimizer's state, per parameter name and state
    key. Torch's moments are made like their parameter (``zeros_like``), so
    they take its placement by construction, as JAX's rule assigns; scalar
    state (the step) is a plain tensor, replicated."""
    names = {id(p): n for n, p in module.named_parameters()}
    out = {}
    for p, st in optimizer.state.items():
        if id(p) in names:
            out[names[id(p)]] = {k: placements(v) for k, v in st.items()
                                 if isinstance(v, torch.Tensor)}
    return out


def whole(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a split (DTensor) one, a collective every rank of
    its mesh calls; a plain tensor as it is. An even split over one mesh
    axis (tp) is assembled by one all-reduce of a zeroed buffer holding this
    rank's block: DTensor's own gather goes through functional collectives,
    which gloo on CUDA tensors does not survive (torch 2.11, the two-rank
    check on one card). Other layouts (FSDP over tp) take DTensor's gather."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return t
    mesh, (place,) = t.device_mesh, t.placements[:1]
    if mesh.ndim == 1 and isinstance(place, Shard) and t.shape[place.dim] % mesh.size() == 0:
        local = t.to_local().detach()
        full = local.new_zeros(t.shape)
        full.narrow(place.dim, mesh.get_local_rank() * local.shape[place.dim],
                    local.shape[place.dim]).copy_(local)
        dist.all_reduce(full, group=mesh.get_group())
        return full
    if mesh.ndim == 1 and not isinstance(place, Shard) and not place.is_partial():
        return t.to_local()
    return t.full_tensor()


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with whole tensors: tp- or FSDP-split ones are
    gathered (``whole``, a collective: every rank calls it)."""
    return {k: whole(v) for k, v in module.state_dict().items()}


def draw_rows(draws: Dict[str, Any], sharding: BatchSharding) -> Dict[str, Any]:
    """This rank's rows of per-step draws made for the global batch: each
    tensor's leading batch dim, or each tensor of a list (the brain's
    dropout masks)."""
    def rows(v):
        if isinstance(v, (list, tuple)):
            return [sharding(t) for t in v]
        return None if v is None else sharding(v)

    return {k: rows(v) for k, v in draws.items()}

