"""Port parity, the parallel layer in one process: the tp rules and the FSDP
extension against JAX's, the mesh and ``train-prior --dp`` at world size 1
against the plain run, and the padding and draw rule of ``use_mesh``
serving. The multi-process run is ``test_torch_parallel_dist.py``."""

import ast
import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from _torch_threads import one_torch_thread  # noqa: F401
from avi_talking_tpu.models.conditioning import StyleCondition as JCond
from avi_talking_tpu.models.emote import EmoteConfig as JConfig
from avi_talking_tpu.models.emote import EmoteTalkingHead as JHead
from avi_talking_tpu.parallel import mesh as jmesh
from avi_talking_tpu_torch import parallel
from avi_talking_tpu_torch.cli import main
from avi_talking_tpu_torch.core.assets import synthetic_assets
from avi_talking_tpu_torch.data.batching import prefetch_to_device
from avi_talking_tpu_torch.infra.jax_params import emote_head_state_from_jax
from avi_talking_tpu_torch.parallel import dryrun
from avi_talking_tpu_torch.pipeline import generate as tgen
from avi_talking_tpu_torch.train.driver import PriorTrainingConfig, train_prior

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trim(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def test_tp_rules_match_jax_through_the_name_map():
    """Every parameter of the tiny EMOTE head: the port's spec is JAX's for
    the leaf that ``emote_head_state_from_jax`` carries into it, a 2-D
    kernel's transposed (flax (in, out), torch (out, in))."""
    cfg = JConfig.tiny()
    head = JHead(cfg)
    cond = JCond(jnp.zeros((1, 8)), jnp.zeros((1, 3)), jnp.zeros((1, 32)),
                 jnp.zeros((1, cfg.n_shape)))
    shapes = jax.eval_shape(lambda: head.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 640)), cond))
    paths = {}

    def tag(path, leaf):  # each leaf holds its own number, which the carry keeps
        paths[len(paths) + 1] = "/".join(str(getattr(k, "key", k)) for k in path)
        return np.full(leaf.shape, len(paths), np.float32)

    state = emote_head_state_from_jax(jax.tree_util.tree_map_with_path(tag, shapes))
    hits = {"tp": 0}
    port = dryrun.build_emote_head(True, "cpu")
    names = [n for n, _ in port.named_parameters()]
    assert set(names) <= set(state)
    for name in names:
        ids = np.unique(np.asarray(state[name]))
        assert len(ids) == 1, name
        path = paths[int(ids[0])]
        jspec = tuple(jmesh.emote_param_sharding_rules(path))
        if path.endswith("kernel") and len(state[name].shape) == 2:
            jspec = tuple(reversed(jspec + (None,) * (2 - len(jspec))))
        got = parallel.emote_param_sharding_rules(name)
        assert _trim(got) == _trim(jspec), (name, path, got, jspec)
        hits["tp"] += "tp" in got
    # per layer: q / k / v / intermediate weights and biases, out / output weights
    assert hits["tp"] == 10 * cfg.wav2vec2.num_hidden_layers


SHAPES = [(), (8,), (64, 128), (128, 64), (96, 96), (100, 7), (7, 100), (512, 24),
          (3, 3, 64), (4096,), (48, 48)]


@pytest.mark.parametrize("min_size", [256, 8192])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_fsdp_extend_spec_matches_jax(min_size, n):
    """JAX's rule over shapes, base specs and dp sizes, on a stand-in mesh
    (JAX's function reads only ``mesh.shape[axis]``)."""
    mesh = types.SimpleNamespace(shape={"dp": n})
    for shape in SHAPES:
        for base in (P(), P(None, "tp"), P("tp", None), P("tp"), P("dp")):
            want = tuple(jmesh.fsdp_extend_spec(base, shape, mesh, "dp", min_size))
            got = parallel.fsdp_extend_spec(tuple(base), shape, n, "dp", min_size)
            assert got == want, (shape, tuple(base), got, want)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo group of one process (a FileStore under tmp_path) and its
    mesh; taken down after the test."""
    up = parallel.init_distributed(backend="gloo", store=dist.FileStore(str(tmp_path / "s"), 1),
                                   rank=0, world_size=1)
    assert up
    try:
        yield parallel.make_mesh()
    finally:
        dist.destroy_process_group()


def test_init_distributed_is_a_no_op_in_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert parallel.init_distributed(device="cpu") is False
    assert not dist.is_initialized() and parallel.is_main_process()


def test_make_mesh_at_world_one(world_of_one):
    mesh = world_of_one
    assert mesh.mesh_dim_names == ("dp", "tp") and tuple(mesh.shape) == (1, 1)
    assert parallel.batch_sharding(mesh) == parallel.BatchSharding(0, 1)
    with pytest.raises(AssertionError, match=r"dp\(2\) \* tp\(1\) != devices\(1\)"):
        parallel.make_mesh(dp=2)


def test_train_prior_with_a_mesh_of_one_is_the_plain_run(world_of_one):
    cfg = PriorTrainingConfig(total_steps=3, batch_size=4, clip_size=16, in_dim=24, depth=1,
                              heads=2, dim_head=8, brain_hidden=32, timesteps=5)
    plain = train_prior(cfg, device="cpu")
    meshed = train_prior(cfg, device="cpu", mesh=world_of_one)
    assert plain["metrics"] == meshed["metrics"]
    for a, b in zip(plain["state"].brain.parameters(), meshed["state"].brain.parameters()):
        assert torch.equal(a, b)


def test_train_prior_dp_in_one_process_is_the_plain_run(capsys, monkeypatch):
    """``--dp`` without a launch (no WORLD_SIZE) runs the plain loop, as
    JAX's does on one device."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = ["train-prior", "--tiny", "--device", "cpu", "--steps", "3", "--batch-size", "4"]
    assert main(args) == 0
    plain = capsys.readouterr().out
    assert main(args + ["--dp"]) == 0
    assert capsys.readouterr().out == plain and "final: {" in plain


def test_train_prior_dp_on_two_processes_is_the_unsharded_step(tmp_path):
    """``train-prior --dp`` under ``torch.distributed.run`` with two gloo
    ranks: the final metrics are the one-process run's (1e-5 relative)."""
    base = [sys.executable, "-m", "avi_talking_tpu_torch.cli", "train-prior", "--tiny",
            "--device", "cpu", "--steps", "2", "--batch-size", "4"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}

    procs = [subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in (base, [sys.executable, "-m", "torch.distributed.run", "--standalone",
                                "--nproc_per_node", "2", *base[1:], "--dp"])]
    finals = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-2000:]
        lines = [x for x in stdout.splitlines() if x.startswith("final: ")]
        assert len(lines) == 1, stdout  # rank 0 alone prints
        finals.append(ast.literal_eval(lines[0][len("final: "):]))
    plain, dp = finals
    assert list(dp) == list(plain)
    for k, v in plain.items():
        assert dp[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k


class _FakeDp:
    """A mesh stand-in: rank ``rank`` of a dp axis of ``size``."""

    def __init__(self, rank, size):
        self.sub = types.SimpleNamespace(get_local_rank=lambda: rank, size=lambda: size)

    def __getitem__(self, axis):
        assert axis == "dp"
        return self.sub


@pytest.mark.parametrize("n,size,rows", [
    (3, 2, [[0, 1], [2, 0]]), (4, 2, [[0, 1], [2, 3]]), (1, 2, [[0], [0]]),
    (5, 4, [[0, 1], [2, 3], [4, 0], [0, 0]]),
])
def test_use_mesh_pads_with_the_first_row(n, size, rows):
    for rank in range(size):
        pipe = types.SimpleNamespace(mesh=_FakeDp(rank, size), _dp=lambda: size)
        assert tgen.AviTalkingPipeline._local_rows(pipe, n).tolist() == rows[rank]


@pytest.fixture(scope="module")
def tiny_pipe():
    cfg = tgen.PipelineConfig.tiny()
    return tgen.AviTalkingPipeline.random_init(
        cfg, synthetic_assets(n_shape=cfg.emote.n_shape, n_exp=cfg.emote.flint.n_exp),
        device="cpu")


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_use_mesh_draws_for_the_unpadded_global_batch(tiny_pipe, sampler, monkeypatch):
    """Each rank's style rows (before the gather) are the unsharded ones at
    its padded row indices: the noise is drawn for the three requests from
    the one seeded generator, whatever the rank and the padding."""
    pipe = dataclasses.replace(tiny_pipe)
    ids = pipe._token_ids(["a happy person", "sad", "angry man"])
    with torch.no_grad():
        ref = pipe._style(ids, seed=4, cond_scale=1.0, sampler=sampler, ddim_steps=3)
        monkeypatch.setattr(tgen, "dp_gather", lambda x, mesh: x)
        for rank, idx in enumerate([[0, 1], [2, 0]]):
            pipe.use_mesh(_FakeDp(rank, 2))
            got = pipe._style(ids, seed=4, cond_scale=1.0, sampler=sampler, ddim_steps=3)
            torch.testing.assert_close(got, ref[idx], atol=1e-6, rtol=0)


def test_prefetch_copies_only_this_ranks_rows():
    batches = [{"x": np.arange(12, dtype=np.float32).reshape(4, 3), "name": "b", "s": 2.0}]
    got = list(prefetch_to_device(iter(batches), device="cpu",
                                  sharding=parallel.BatchSharding(rank=1, size=2)))
    assert got[0]["name"] == "b" and got[0]["s"] == 2.0
    np.testing.assert_array_equal(got[0]["x"].numpy(), batches[0]["x"][2:])


def test_batch_sharding_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="does not split"):
        parallel.BatchSharding(0, 2)(np.zeros((3, 2)))


def test_package_exports_jax_names():
    from avi_talking_tpu import parallel as jpar

    jnames = {n for n in dir(jpar) if not n.startswith("_") and n != "mesh"}
    assert jnames <= set(dir(parallel)) and "param_shardings" in dir(parallel)
    assert os.path.basename(parallel.__file__) == "__init__.py"
