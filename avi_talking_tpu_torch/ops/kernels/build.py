"""Build the port's CUDA kernels from the repository's sources at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, under ``build/avi_talking_tpu_torch/``
beside the package, and loaded with ctypes. The library's file name carries
a hash of its source and flags, so an edited source is rebuilt. Nothing here
runs when a module is imported: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "avi_talking_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], Callable[..., int]] = {}
# first use may come from several server threads; function() loads under it
_load_lock = threading.RLock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from csrc/ on the machine with the card")


def library_path(name: str) -> Path:
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together. Returns, for each build that ran, its
    wall seconds and the compiler's log (``-Xptxas -v``: registers, shared
    memory and spills per kernel); an already built library is absent."""
    running = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        running[name] = (proc, tmp, lib, time.perf_counter())
    done = {}
    for name, (proc, tmp, lib, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log.decode()}")
        os.replace(tmp, lib)
        done[name] = {"seconds": time.perf_counter() - t0, "log": log.decode()}
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: Sequence) -> Callable[..., int]:
    """The C entry ``symbol`` of ``csrc/<name>.cu`` with its ctypes signature
    (``argtypes``, an int result) set once, at first use, when the library
    is built and loaded under the lock; later calls take no lock."""
    fn = _functions.get((name, symbol))
    if fn is None:
        with _load_lock:
            fn = _functions.get((name, symbol))
            if fn is None:
                fn = getattr(load(name), symbol)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                _functions[(name, symbol)] = fn
    return fn


def launch(fn: Callable[..., int], device: torch.device, *args) -> int:
    """Call a bound entry with ``args`` and then the current stream of
    ``device``, entering the device's context only when it is not the
    current device. Returns the entry's cudaError_t."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
