"""The port's micro-batching server (pipeline/server.py) on the tiny CPU
pipeline: request coalescing, batch / length bucketing, per-request
unpadding, seed grouping, failure propagation, stats, warmup (the cases of
tests/test_server.py), and the kernels' launch counters under the server's
worker threads."""

import sys
import time

import numpy as np
import pytest

from avi_talking_tpu_torch.core.assets import synthetic_assets
from avi_talking_tpu_torch.ops.kernels import keybias_attention as kb
from avi_talking_tpu_torch.ops.kernels import rasterize as kras
from avi_talking_tpu_torch.pipeline import AviTalkingPipeline, PipelineConfig
from avi_talking_tpu_torch.pipeline.server import InferenceServer, ServingConfig
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def pipe():
    return AviTalkingPipeline.random_init(
        PipelineConfig.tiny(), synthetic_assets(n_shape=8, n_exp=6), device="cpu")


@pytest.fixture()
def server(pipe):
    cfg = ServingConfig(max_batch=4, max_wait_ms=40.0, batch_buckets=(1, 2, 4),
                        length_buckets=(64, 128))
    with InferenceServer(pipe, cfg) as s:
        yield s


def test_single_request_matches_direct_batch_path(pipe, server):
    wav = np.random.default_rng(0).uniform(-0.3, 0.3, 16000).astype(np.float32)
    out = server.generate(wav, "a happy person", seed=3, timeout=300)
    ref = pipe.generate_batch([wav], ["a happy person"], seed=3, length_buckets=(64, 128))[0]
    np.testing.assert_allclose(out["exp"], ref["exp"], atol=1e-6)
    np.testing.assert_allclose(out["style_emb"], ref["style_emb"], atol=1e-6)
    assert "vertices" not in out  # return_vertices is off by default


def test_coalescing_pads_batch_and_unpads_results(pipe, server):
    rng = np.random.default_rng(1)
    wavs = [rng.uniform(-0.3, 0.3, n).astype(np.float32) for n in (8000, 16000, 24000)]
    futs = [server.submit(w, f"instruction {i}") for i, w in enumerate(wavs)]
    outs = [f.result(timeout=300) for f in futs]
    lens = [o["exp"].shape[0] for o in outs]
    assert lens[0] < lens[1] < lens[2]
    for o in outs:
        assert np.isfinite(o["exp"]).all()
    # 3 requests coalesced -> padded to the 4-bucket (or split under timing jitter)
    assert server.stats["padded_batch"][0] in (2, 4)
    assert sum(server.stats["batch_size"]) == 3
    if server.stats["padded_batch"] == [4]:  # one micro-batch: rows 0-2 of a padded 4
        refs = pipe.generate_batch(wavs + [wavs[0]], [f"instruction {i}" for i in (0, 1, 2, 0)],
                                   seed=0, length_buckets=(64, 128))
        for o, r in zip(outs, refs):
            np.testing.assert_allclose(o["exp"], r["exp"], atol=1e-5)


def test_different_seeds_do_not_share_a_batch(pipe, server):
    wav = np.zeros(8000, np.float32)
    f1 = server.submit(wav, "same text", seed=1)
    f2 = server.submit(wav, "same text", seed=2)
    o1, o2 = f1.result(timeout=300), f2.result(timeout=300)
    assert not np.allclose(o1["style_emb"], o2["style_emb"])
    r1 = pipe.generate_batch([wav], ["same text"], seed=1, length_buckets=(64, 128))[0]
    np.testing.assert_allclose(o1["style_emb"], r1["style_emb"], atol=1e-6)


def test_oversized_clip_fails_only_its_batch(pipe, server):
    ok = server.submit(np.zeros(8000, np.float32), "fine", seed=9)
    too_long = server.submit(np.zeros(16000 * 60, np.float32), "too long", seed=8)
    with pytest.raises(ValueError):
        too_long.result(timeout=300)
    assert ok.result(timeout=300)["exp"].shape[0] > 0


def test_latency_stats_and_close(pipe):
    cfg = ServingConfig(max_batch=2, max_wait_ms=1.0, batch_buckets=(1, 2), length_buckets=(64,))
    s = InferenceServer(pipe, cfg)
    s.generate(np.zeros(8000, np.float32), "x", timeout=300)
    pct = s.latency_percentiles()
    assert pct["p50"] > 0 and pct["p99"] >= pct["p50"]
    bd = s.stage_breakdown()
    for key in ("queue_wait_ms", "framing_ms", "style_dispatch_ms", "prep_ms", "device_fetch_ms"):
        assert np.isfinite(bd[key]) and bd[key] >= 0.0, key
    stages_sum = sum(v for k, v in bd.items() if k != "queue_wait_ms")
    assert stages_sum <= pct["p50"] * 1.05  # stages nest inside latency
    s.clear_stats()
    assert all(not v for v in s.stats.values())
    assert np.isnan(s.latency_percentiles()["p50"])
    s.close()
    s.close()  # idempotent
    with pytest.raises(RuntimeError):
        s.submit(np.zeros(100, np.float32), "y")
    with pytest.raises(ValueError, match="max_batch"):
        InferenceServer(pipe, ServingConfig(max_batch=8, batch_buckets=(1, 2)))


def test_warmup_runs_all_buckets(pipe):
    cfg = ServingConfig(max_batch=2, max_wait_ms=1.0, batch_buckets=(1, 2), length_buckets=(64,))
    calls = []

    class Recording:
        cfg = pipe.cfg

        def generate_batch(self, wavs, instructions, **kw):
            calls.append(len(wavs))
            return pipe.generate_batch(wavs, instructions, **kw)

    with InferenceServer(Recording(), cfg) as s:
        s.warmup()
        assert calls == [1, 2]
        t0 = time.perf_counter()
        s.generate(np.zeros(8000, np.float32), "warm", timeout=300)
        warm_ms = (time.perf_counter() - t0) * 1e3
    assert warm_ms < 5000


def test_launch_counters_add_up_under_server_threads():
    """Two micro-batches in flight at once (pipeline_depth=2), each
    counting kernel launches the way the CUDA wrappers do: no update is
    lost. The switch interval is shortened so the threads interleave."""
    per_call = 3000

    class Counting:
        cfg = PipelineConfig.tiny()

        def generate_batch(self, wavs, instructions, **kw):
            for _ in range(per_call):
                kb._count_launch()
                kras._count_launch()
            return [{"exp": np.zeros((1, 6), np.float32)} for _ in wavs]

    kb0, kr0 = kb.launches, kras.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        cfg = ServingConfig(max_batch=1, max_wait_ms=0.0, batch_buckets=(1,), pipeline_depth=2)
        with InferenceServer(Counting(), cfg) as s:
            futs = [s.submit(np.zeros(640, np.float32), "x", seed=i) for i in range(8)]
            for f in futs:
                f.result(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert kb.launches - kb0 == 8 * per_call
    assert kras.launches - kr0 == 8 * per_call
    kb.launches, kras.launches = kb0, kr0
