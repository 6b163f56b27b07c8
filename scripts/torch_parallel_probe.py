#!/usr/bin/env python3
"""What the parallel layer can run on one card, each case timed.

    python scripts/torch_parallel_probe.py

Prints one JSON line each (and appends it to
build/torch_parallel_probe.jsonl): the versions and the card; which
collectives gloo runs on CUDA tensors with two ranks on the one card
(all_reduce, broadcast, all_gather, all_gather_into_tensor,
reduce_scatter_tensor, scatter, all_to_all_single, barrier, a
DeviceMesh); the dry-run cases of ``parallel/dryrun.py`` through gloo on
the card (two ranks) and on a world-1 NCCL group at full width. A probe:
each failure is recorded with its traceback and the next case runs
(``chip_smoke.py``'s parallel phase fails instead)."""
import json, os, sys, tempfile, time, traceback
sys.path.insert(0, os.getcwd())
import torch, torch.distributed as dist, torch.multiprocessing as mp

OUT = "build/torch_parallel_probe.jsonl"


def emit(o):
    print(json.dumps(o, default=str), flush=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(o, default=str) + "\n")


def coll(rank, n, store_path, q):
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n), rank=rank, world_size=n)
    torch.cuda.set_device(0)
    x = torch.ones(4, device="cuda") * (rank + 1)
    res = {}

    def t(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except Exception as e:  # noqa: BLE001
            res[name] = repr(e)[:300]
    t("all_reduce", lambda: dist.all_reduce(x.clone()))
    t("broadcast", lambda: dist.broadcast(x.clone(), 0))
    t("all_gather", lambda: dist.all_gather([torch.empty_like(x) for _ in range(n)], x))
    t("all_gather_into_tensor",
      lambda: dist.all_gather_into_tensor(torch.empty(n * 4, device="cuda"), x))
    t("reduce_scatter_tensor",
      lambda: dist.reduce_scatter_tensor(torch.empty(2, device="cuda"), x))
    t("scatter", lambda: dist.scatter(torch.empty(4, device="cuda"),
                                      [x.clone(), x.clone()] if rank == 0 else None, 0))
    t("all_to_all_single", lambda: dist.all_to_all_single(torch.empty(4, device="cuda"), x))
    t("barrier", dist.barrier)
    from torch.distributed.device_mesh import init_device_mesh
    t("device_mesh", lambda: init_device_mesh("cuda", (1, 2), mesh_dim_names=("dp", "tp")))
    if rank == 0:
        q.put(res)
    dist.barrier()
    dist.destroy_process_group()


def main():
    os.makedirs("build", exist_ok=True)
    emit({"python": sys.version, "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": torch.cuda.get_device_name(0)})
    from avi_talking_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    build.build(["bias_attention", "keybias_attention_bf16", "rasterize_visibility"])
    emit({"build_s": time.perf_counter() - t0})
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        mp.start_processes(coll, args=(2, os.path.join(tmp, "s"), q), nprocs=2,
                           start_method="spawn")
    emit({"gloo_cuda_collectives": q.get()})

    from avi_talking_tpu_torch.parallel import dryrun
    for key, case, shape, kw in [
            ("emote_tp2_tiny", "emote", (1, 2), {"fsdp": False}),
            ("prior_dp2_tiny", "prior", (2, 1), {}),
            ("serve_dp2_tiny", "serve", (2, 1), {}),
            ("neural_tp2_tiny", "neural", (1, 2), {}),
            ("emote_fsdp_dp2_tiny", "emote", (2, 1), {}),
            ("emote_tp2_full", "emote", (1, 2), {"tiny": False, "B": 8, "T": 64, "fsdp": False}),
            ("prior_dp2_full", "prior", (2, 1), {"full": True, "B": 256}),
            ("serve_dp2_full", "serve", (2, 1), {"tiny": False, "n_clips": 6, "samples": 64000,
                                                 "buckets": (64, 128, 256, 512)})]:
        t0 = time.perf_counter()
        try:
            r = dryrun.run_ranks(2, [(key, case, shape, kw)], "cuda", backend="gloo",
                                 workdir="build")
            emit({"case": key, "ok": True, "s": time.perf_counter() - t0,
                  "result": {k: v for k, v in r[key].items()
                             if k not in ("state_tp", "state_dp", "outputs")},
                  "by_rank": r["by_rank"]})
        except Exception:  # noqa: BLE001
            emit({"case": key, "ok": False, "s": time.perf_counter() - t0,
                  "error": traceback.format_exc()[-3000:]})

    from avi_talking_tpu_torch.parallel import init_distributed, make_mesh
    init_distributed(backend="nccl", store=dist.HashStore(), rank=0, world_size=1)
    mesh = make_mesh()
    for key, case, kw in [
            ("emote_w1_full", "emote", {"tiny": False, "B": 8, "T": 64}),
            ("prior_w1_full", "prior", {"full": True, "B": 256}),
            ("serve_w1_full", "serve", {"tiny": False, "n_clips": 6, "samples": 64000,
                                        "buckets": (64, 128, 256, 512)}),
            ("neural_w1_full", "neural", {"tiny": False, "B": 2, "T": 32})]:
        t0 = time.perf_counter()
        try:
            r = dryrun.run_plan(lambda dp, tp: mesh, "cuda:0", [(key, case, (1, 1), kw)], {})
            emit({"case": key, "ok": True, "s": time.perf_counter() - t0,
                  "result": {k: v for k, v in r[key].items()
                             if k not in ("state_tp", "state_dp", "outputs")}})
        except Exception:  # noqa: BLE001
            emit({"case": key, "ok": False, "s": time.perf_counter() - t0,
                  "error": traceback.format_exc()[-3000:]})
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
