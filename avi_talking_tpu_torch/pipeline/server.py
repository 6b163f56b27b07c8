"""Micro-batching inference server for the wav + instruction -> face
pipeline (port of ``avi_talking_tpu/pipeline/server.py``).

Requests are queued on the host and coalesced into micro-batches, one
``generate_batch`` call each:

- ``submit()`` is non-blocking and returns a Future; one collector thread
  drains the queue, lingers up to ``max_wait_ms`` for more requests, splits
  the batch by seed (one seed drives a whole ``generate_batch`` call), pads
  the batch dim up to the next batch bucket (extra rows repeat row 0 and
  are dropped on return) and hands it to a pool of ``pipeline_depth``
  threads, so the host framing and tokenising of one micro-batch overlaps
  the device work of the one before. Each ``generate_batch`` call makes its
  own generator and runs under its own (thread-local) ``inference_mode``;
  the kernels' launch counters take a lock.
- ``warmup()`` runs every (batch bucket x length bucket) shape once, so the
  first real request does not pay the kernels' build or the first use of
  a shape.
- A failure fails only the futures of its micro-batch.

``stats`` keeps per-request latency and queue wait and per-batch occupancy
and the ``generate_batch`` stage times; ``latency_percentiles`` and
``stage_breakdown`` summarise them.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    max_batch: int = 16
    max_wait_ms: float = 5.0  # collector linger before dispatching a partial batch
    batch_buckets: Sequence[int] = (1, 2, 4, 8, 16)
    length_buckets: Sequence[int] = (64, 128, 256, 512)
    sample_rate: int = 16_000
    # concurrent in-flight micro-batches: host framing / tokenising of
    # batch N overlaps the device work of batch N-1. 1 = serial.
    pipeline_depth: int = 2
    # return the (T, V, 3) vertices of every request? Off by default: the
    # coefficients are a few KB and FLAME-decode anywhere.
    return_vertices: bool = False


@dataclasses.dataclass
class _Request:
    wav: Any  # float waveform array or .wav path
    instruction: str
    seed: int
    future: Future
    t_submit: float


class InferenceServer:
    """Queue + collector thread over ``AviTalkingPipeline.generate_batch``."""

    def __init__(self, pipeline, cfg: Optional[ServingConfig] = None):
        self.pipeline = pipeline
        self.cfg = cfg or ServingConfig()
        if self.cfg.max_batch > max(self.cfg.batch_buckets):
            raise ValueError(f"max_batch {self.cfg.max_batch} exceeds the largest batch "
                             f"bucket {max(self.cfg.batch_buckets)}")
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._closed = False
        # per request: latency_ms, queue_wait_ms; per batch: batch_size,
        # padded_batch and the generate_batch stage times
        self.stats: Dict[str, List[float]] = {
            "latency_ms": [], "queue_wait_ms": [], "batch_size": [],
            "padded_batch": [], "framing_ms": [], "style_dispatch_ms": [],
            "prep_ms": [], "device_fetch_ms": []}
        self._stats_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=max(1, self.cfg.pipeline_depth))
        self._inflight: "queue.Queue" = queue.Queue(maxsize=max(1, self.cfg.pipeline_depth))
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- client API --------------------------------------------------------

    def submit(self, wav, instruction: str, seed: int = 0) -> Future:
        """``wav``: float waveform array or a .wav path (as
        ``generate_batch`` takes)."""
        if self._closed:
            raise RuntimeError("server closed")
        if not isinstance(wav, str):
            wav = np.asarray(wav, np.float32)
        fut: Future = Future()
        self._q.put(_Request(wav, instruction, seed, fut, time.perf_counter()))
        return fut

    def generate(self, wav, instruction: str, seed: int = 0, timeout=None):
        """Blocking convenience wrapper."""
        return self.submit(wav, instruction, seed).result(timeout=timeout)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- shape management ---------------------------------------------------

    def _batch_bucket(self, n: int) -> int:
        for b in sorted(self.cfg.batch_buckets):
            if n <= b:
                return b
        return max(self.cfg.batch_buckets)

    def warmup(self, seconds_per_bucket: Optional[Sequence[float]] = None):
        """Run every (batch bucket, length bucket) shape once."""
        lfs = self.pipeline.cfg.emote.flint.latent_frame_size
        lengths = [b - b % lfs for b in self.cfg.length_buckets]
        secs = seconds_per_bucket or [t / 25.0 for t in lengths]
        for sec in secs:
            wav = np.zeros(int(sec * self.cfg.sample_rate), np.float32)
            for bb in sorted(set(self.cfg.batch_buckets)):
                if bb > self.cfg.max_batch:
                    break
                self.pipeline.generate_batch(
                    [wav] * bb, ["warmup"] * bb, seed=0,
                    length_buckets=tuple(self.cfg.length_buckets),
                    sample_rate=self.cfg.sample_rate,
                    return_vertices=self.cfg.return_vertices,
                )

    # -- collector ----------------------------------------------------------

    def _collect(self) -> List[_Request]:
        """Block for one request, then linger up to max_wait_ms for more."""
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.cfg.max_wait_ms / 1e3
        while len(batch) < self.cfg.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                req = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if req is None:
                self._q.put(None)  # keep the poison pill for the main loop
                break
            batch.append(req)
        return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if not batch:
                self._pool.shutdown(wait=True)
                return
            # one generator covers a whole generate_batch call, so requests
            # with different seeds must not share a micro-batch
            groups: Dict[int, List[_Request]] = {}
            for r in batch:
                groups.setdefault(r.seed, []).append(r)
            for grp in groups.values():
                self._inflight.put(None)  # at most pipeline_depth in flight
                self._pool.submit(self._dispatch_safe, grp)

    def _dispatch_safe(self, grp: List[_Request]) -> None:
        try:
            self._dispatch(grp)
        except Exception as e:  # fail only this micro-batch
            for r in grp:
                if not r.future.done():
                    r.future.set_exception(e)
        finally:
            self._inflight.get()

    def _dispatch(self, batch: List[_Request]) -> None:
        n = len(batch)
        padded = self._batch_bucket(n)
        wavs = [r.wav for r in batch] + [batch[0].wav] * (padded - n)
        instrs = [r.instruction for r in batch] + [batch[0].instruction] * (padded - n)
        t_start = time.perf_counter()
        stages: Dict[str, float] = {}
        outs = self.pipeline.generate_batch(
            wavs, instrs, seed=batch[0].seed,
            length_buckets=tuple(self.cfg.length_buckets),
            sample_rate=self.cfg.sample_rate,
            return_vertices=self.cfg.return_vertices,
            stage_times=stages,
        )
        now = time.perf_counter()
        with self._stats_lock:
            self.stats["batch_size"].append(n)
            self.stats["padded_batch"].append(padded)
            for k, v in stages.items():
                self.stats[k].append(v)
            for r in batch:
                self.stats["latency_ms"].append((now - r.t_submit) * 1e3)
                self.stats["queue_wait_ms"].append((t_start - r.t_submit) * 1e3)
        for r, out in zip(batch, outs):
            r.future.set_result(out)

    # -- observability -------------------------------------------------------

    def latency_percentiles(self, qs=(50, 99)) -> Dict[str, float]:
        lat = list(self.stats["latency_ms"])
        if not lat:
            return {f"p{q}": float("nan") for q in qs}
        return {f"p{q}": float(np.percentile(lat, q)) for q in qs}

    def stage_breakdown(self) -> Dict[str, float]:
        """Median per-batch stage times (ms) and median per-request queue
        wait: where a request's latency goes. ``device_fetch_ms`` is the
        blocking device-to-host copy, which waits for the device work."""
        keys = ("queue_wait_ms", "framing_ms", "style_dispatch_ms", "prep_ms", "device_fetch_ms")
        return {k: (float(np.median(self.stats[k])) if self.stats[k] else float("nan"))
                for k in keys}

    def clear_stats(self) -> None:
        with self._stats_lock:
            for v in self.stats.values():
                v.clear()
