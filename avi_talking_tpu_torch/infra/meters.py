"""Scalar logging of the training loops (port of
``avi_talking_tpu/infra/meters.py``).

``ScalarWriter(logdir)`` writes an always-on ``scalars.jsonl`` (one JSON
object per scalar: time, step, name: value) and a TensorBoard event file
when ``torch.utils.tensorboard`` imports (its absence is no error, as in
the JAX package). The writer is an object the loop owns and closes; the
JAX module's global writers, its ``Meter`` averages and its rank-0 gate
have no counterpart, since the loops log single values from one process.
JAX's
``profile_region`` / ``trace`` (``jax.profiler``) are not ported: the
port's device timing is ``chip_smoke.py``'s ``torch.profiler`` sessions.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Optional


class ScalarWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(logdir)

    def add_scalar(self, name: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(name, value, step)
        self._jsonl.write(json.dumps({"t": time.time(), "step": step, name: value}) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self) -> "ScalarWriter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def write_metrics(writer: Optional[ScalarWriter], metrics: Dict[str, float], step: int,
                  prefix: str = "") -> None:
    """Adds each finite value of ``metrics`` to ``writer`` under ``prefix``
    (nothing when there is no writer)."""
    if writer is None:
        return
    for k, v in metrics.items():
        if math.isfinite(float(v)):
            writer.add_scalar(prefix + k, float(v), step)
