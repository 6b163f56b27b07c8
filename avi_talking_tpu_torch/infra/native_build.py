"""Build the repository's host codecs (``native/*.cpp``) at first use.

``native/wavio.cpp`` (wav decode and framing) and ``native/imageio.cpp``
(PNG decode, linked with zlib) are compiled where they are, never edited,
with the flags of ``native/Makefile`` (``g++ -O3 -fPIC -std=c++17
-shared``), into ``build/avi_talking_tpu_torch/`` beside the CUDA
kernels, and loaded with ctypes. The library's file name carries a hash of
its source and flags, so an edited source is rebuilt; a build writes a
temporary file and renames it into place, so processes that build at once
each load a whole library. A library that ``make -C native`` left in
``native/`` is never read. A compiler that is missing or fails raises with
its output: nothing falls back to the Python codecs when a build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from ..ops.kernels.build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = {"wavio": (), "imageio": ("-lz",)}

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ or $CXX): the host codecs are built from "
                           "native/*.cpp at first use")
    return cxx


def library_path(name: str) -> Path:
    source = (NATIVE_DIR / f"{name}.cpp").read_bytes()
    flags = " ".join(CXX_FLAGS + LIBS[name])
    digest = hashlib.sha256(source + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp`` (``wavio`` or
    ``imageio``), built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
                cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(NATIVE_DIR / f"{name}.cpp"),
                       *LIBS[name]]
                done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                if done.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"building native/{name}.cpp failed:\n"
                                       f"{' '.join(cmd)}\n{done.stdout.decode()}")
                os.replace(tmp, path)
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
