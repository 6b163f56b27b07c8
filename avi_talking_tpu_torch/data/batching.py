"""Host-side batching (port of ``pad_to_bucket``, ``batch_iterator`` and
``default_collate`` from ``avi_talking_tpu/data/batching.py``): numpy
batches, drawn in the JAX package's order for the same seed."""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


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
