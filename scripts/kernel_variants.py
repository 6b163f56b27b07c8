"""Source variants of one of the port's CUDA kernels, built and timed on the
card: what scripts/torch_attention_variants.py and
scripts/torch_visibility_variants.py share. A variant is the kernel's
source (avi_talking_tpu_torch/csrc/<name>.cu) with named (old, new) text
edits; each is built with nvcc into build/variants/, all at once, bound
through ctypes, and timed against the others in turns."""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chip_smoke(script: str):
    """chip_smoke.py of this checkout as a module (its timers and inputs),
    with the port importable; exits with code 2 when no card is present."""
    import torch

    if not torch.cuda.is_available():
        print(f"{script}: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def build_variants(source: str, entry: str, argtypes, variants: dict, names) -> dict:
    """Each named variant of csrc/<source>.cu with its edits applied (it
    stops if an edit no longer applies), compiled by one nvcc per variant,
    all started together. Prints a JSON line per variant with its ptxas
    lines; returns {name: the bound C entry ``entry``}."""
    from avi_talking_tpu_torch.ops.kernels import build

    with open(os.path.join(build.CSRC_DIR, f"{source}.cu")) as f:
        text0 = f.read()
    out_dir = os.path.join(ROOT, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        text = text0
        for old, new in variants[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: the edit no longer applies: {old!r}")
            text = text.replace(old, new)
        src = os.path.join(out_dir, f"{source}_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"lib{source}_{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} does not build:\n{log}")
        print(json.dumps({"variant": name, "ptxas": [
            line.strip() for line in log.splitlines() if "Used" in line or "spill" in line]}),
            flush=True)
        fns[name] = bind(source, name, entry, argtypes)
    return fns


def bind(source: str, name: str, entry: str, argtypes):
    """The C entry ``entry`` of variant ``name`` of csrc/<source>.cu, once
    build_variants has built it."""
    lib = os.path.join(ROOT, "build", "variants", f"lib{source}_{name}.so")
    fn = getattr(ctypes.CDLL(lib), entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def in_turns(fns: dict, measure, rounds: int = 2) -> dict:
    """{name: [measure(fn) per round]}, the variants taken in turns within
    each round, so that a drift of the card's clock spreads over all."""
    row = {}
    for _ in range(rounds):
        for name, fn in fns.items():
            row.setdefault(name, []).append(measure(fn))
    return row


def print_card() -> None:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
