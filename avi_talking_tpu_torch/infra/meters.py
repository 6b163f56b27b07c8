"""Scalar logging of the training loops (port of
``avi_talking_tpu/infra/meters.py``).

``ScalarWriter(logdir)`` writes an always-on ``scalars.jsonl`` (one JSON
object per scalar: time, step, name: value) and a TensorBoard event file
when ``torch.utils.tensorboard`` imports (its absence is no error, as in
the JAX package). The writer is an object the loop owns and closes.

``Meter`` is the reference's running-average meter (``write`` values,
``flush(step)`` their mean): it writes to the writer it is given, else to
the one ``set_summary_writer`` installed, JAX's global. Both write on rank 0
only when a ``torch.distributed`` group is up (JAX's ``process_index``
gate). ``profile_region`` is a ``torch.profiler.record_function`` range
with a wall timer, ``trace(logdir)`` a ``torch.profiler`` session that
TensorBoard reads. torch has no profiler server: ``start_profiler_server``
raises and names ``trace``.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional

import torch


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


def _rank0() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


_installed: Optional[ScalarWriter] = None


def set_summary_writer(logdir: str) -> Optional[ScalarWriter]:
    """Install the process's writer under ``logdir`` for the ``Meter``s that
    are given none (on rank 0; elsewhere nothing is installed); returns it.
    A writer installed earlier is closed."""
    global _installed
    if not _rank0():
        return None
    if _installed is not None:
        _installed.close()
    _installed = ScalarWriter(logdir)
    return _installed


class Meter:
    """Running average of one scalar: ``write`` finite values, ``flush(step)``
    their mean to ``writer`` (else the installed one) and start again."""

    def __init__(self, name: str, writer: Optional[ScalarWriter] = None):
        self.name, self.writer = name, writer
        self.values: List[float] = []

    def write(self, value) -> None:
        v = float(value)  # a tensor on the card: one host sync
        if math.isfinite(v):
            self.values.append(v)

    def flush(self, step: int) -> None:
        if not self.values:
            return
        avg = sum(self.values) / len(self.values)
        self.values.clear()
        writer = self.writer or _installed
        if writer is not None and _rank0():
            writer.add_scalar(self.name, avg, step)


class profile_region:
    """``with profile_region(name) as r:`` marks the block as ``name`` in a
    ``torch.profiler`` trace and leaves its wall seconds in ``r.elapsed``
    (the host's clock: work queued on the card may still be running)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "profile_region":
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.elapsed = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        return False


def trace(logdir: str):
    """``with trace(dir):`` records the host and, where there is a card, its
    kernels, and writes a trace TensorBoard's profiler plugin reads under
    ``dir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir))


def start_profiler_server(port: int = 9999) -> None:
    """JAX's ``jax.profiler.start_server``: torch has no profiler server to
    attach to; capture with ``trace(logdir)`` instead."""
    raise NotImplementedError(
        f"torch has no profiler server (port {port}); wrap the work in "
        "avi_talking_tpu_torch.infra.meters.trace(logdir)")
