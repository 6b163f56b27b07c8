"""Host-side batching (port of ``pad_to_bucket``, ``batch_iterator``,
``default_collate``, ``chunked_apply`` and ``prefetch_to_device`` from
``avi_talking_tpu/data/batching.py``): numpy batches, drawn in the JAX
package's order for the same seed, the preprocessors' fixed-size frame
chunks, and batches copied to the card ahead of the step."""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch


def pad_to_bucket(x: np.ndarray, buckets: Sequence[int], axis: int = 0) -> np.ndarray:
    """Zero-pad ``axis`` up to the smallest bucket >= its length."""
    n = x.shape[axis]
    for b in buckets:
        if n <= b:
            pad = [(0, 0)] * x.ndim
            pad[axis] = (0, b - n)
            return np.pad(x, pad)
    raise ValueError(f"length {n} exceeds the largest bucket {buckets[-1]}")


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    collate: Optional[Callable[[List[Any]], Dict[str, np.ndarray]]] = None,
    epochs: Optional[int] = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Epochs over an indexable dataset (``epochs=None``: endless), each in
    the order of ``np.random.default_rng(seed).permutation``."""
    n = len(dataset)
    rng = np.random.default_rng(seed)
    for _ in (itertools.count() if epochs is None else range(epochs)):
        order = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(0, n - (batch_size - 1 if drop_last else 0), batch_size):
            items = [dataset[int(i)] for i in order[s:s + batch_size]]
            yield collate(items) if collate else default_collate(items)


def default_collate(items: List[Any]) -> Dict[str, Any]:
    """Stacks dict (or dataclass) items: arrays of one shape into one array,
    numbers into an array, anything else into a list."""
    if hasattr(items[0], "__dataclass_fields__"):
        items = [vars(i) for i in items]
    out: Dict[str, Any] = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray) and all(v.shape == vals[0].shape for v in vals):
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (np.integer, int, np.floating, float)) and not isinstance(
                vals[0], bool):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals
    return out


def _fetch(n: int, res) -> Any:
    """A chunk's result, its first ``n`` rows, as numpy: dict, or tuple."""
    if isinstance(res, dict):
        return {k: v.detach().cpu().numpy()[:n] for k, v in res.items()}
    if not isinstance(res, tuple):
        res = (res,)
    return tuple(r.detach().cpu().numpy()[:n] for r in res)


def chunked_apply(fn: Callable, frames, max_b: int, inflight: int = 2,
                  device: Optional[torch.device] = None):
    """Run ``fn`` over ``frames`` in chunks of exactly ``max_b`` rows.

    The tail chunk is padded by repeating its last frame, so every call of
    ``fn`` sees one shape. ``frames`` is a numpy array (copied to
    ``device``: on CUDA from pinned host memory with ``non_blocking``) or a
    tensor (used where it lies). Up to ``inflight`` chunk results stay
    unfetched, and so unsynchronised, while later chunks are copied and
    launched; ``inflight=0`` fetches each chunk before the next.

    ``fn(chunk) -> tensor | tuple of tensors | dict``; the results are cut
    back to the true length and concatenated as numpy, one array (or a
    tuple, or a dict) as ``fn`` returns."""
    T = frames.shape[0]
    if T == 0:
        raise ValueError("chunked_apply: empty frame batch")
    on_host = isinstance(frames, np.ndarray)
    if device is None:
        device = torch.device("cpu") if on_host else frames.device
    pending: List[Any] = []  # (n, result) not yet fetched
    outs: List[Any] = []
    for i in range(0, T, max_b):
        chunk = frames[i:i + max_b]
        n = chunk.shape[0]
        if on_host:
            if n < max_b:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], max_b - n, axis=0)])
            chunk = torch.from_numpy(np.ascontiguousarray(chunk))
            if device.type == "cuda":
                chunk = chunk.pin_memory().to(device, non_blocking=True)
            else:
                chunk = chunk.to(device)
        elif n < max_b:
            chunk = torch.cat([chunk, chunk[-1:].expand(max_b - n, *chunk.shape[1:])])
        pending.append((n, fn(chunk)))
        while len(pending) > max(0, inflight):
            outs.append(_fetch(*pending.pop(0)))
    outs.extend(_fetch(*p) for p in pending)
    if isinstance(outs[0], dict):
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    cat = tuple(np.concatenate([o[k] for o in outs]) for k in range(len(outs[0])))
    return cat if len(cat) > 1 else cat[0]


def _to_device(tree: Any, device: torch.device, moved: List[torch.Tensor],
               rows: Optional[Any] = None) -> Any:
    """Array leaves of nested dicts / lists / tuples copied to ``device``
    (recorded in ``moved``), only their ``rows`` (a ``BatchSharding``) when
    given; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device, moved, rows) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device, moved, rows) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    if rows is not None:
        tree = rows(tree).contiguous()
    if device.type == "cuda" and tree.device.type == "cpu":
        tree = tree.pin_memory()
    out = tree.to(device, non_blocking=device.type == "cuda")
    moved.append(out)
    return out


def prefetch_to_device(iterator: Iterator[Any], size: int = 2,
                       device: Optional[Any] = None, sharding: Optional[Any] = None
                       ) -> Iterator[Any]:
    """Batches of ``iterator`` with their array leaves (numpy arrays and
    tensors) on ``device`` (the card unless given), copied ahead of use.

    A daemon thread pulls batches and keeps up to ``size`` in flight, so the
    host's decoding and the copy overlap the step. On the card each batch is
    copied from pinned memory on a side stream; before a batch is yielded
    the consumer's stream waits for that copy's event, and each copied
    tensor is marked used on the consumer's stream (``record_stream``) so
    its memory is not reused while the step reads it. Other leaves (paths,
    strings) pass through; an error of ``iterator`` is raised in the
    consumer. ``sharding`` (``parallel.batch_sharding(mesh)``, JAX's dp
    split) takes this rank's rows of each array leaf before the copy, so
    only they reach the device."""
    from ..infra.device import resolve_device

    device = resolve_device(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    end = object()
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def producer():
        try:
            for batch in iterator:
                moved: List[torch.Tensor] = []
                if side is None:
                    q.put((_to_device(batch, device, moved, sharding), None, moved))
                    continue
                with torch.cuda.stream(side):
                    out = _to_device(batch, device, moved, sharding)
                    copied = torch.cuda.Event()
                    copied.record(side)
                q.put((out, copied, moved))
            q.put(end)
        except BaseException as e:  # noqa: BLE001  handed to the consumer, which raises it
            q.put(e)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        out, copied, moved = item
        if copied is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(copied)
            for t in moved:
                t.record_stream(stream)
        yield out
