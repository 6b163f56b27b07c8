"""ctypes bindings for the native audio front end (``native/wavio.cpp``);
a copy of ``avi_talking_tpu/audio/native.py`` over the library that
``infra.native_build`` builds at first use.

``read_wav_native`` decodes a PCM or float wav to mono float32 and
resamples it linearly to ``target_sr`` (the Python ``frontend.read_wav``
resamples polyphase, so the two agree where no resampling happens);
``frame_audio_native`` is ``frontend.frame_audio`` with the int16 cast
clamped instead of wrapped (equal for samples in [-1, 1)).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ..infra import native_build
from .frontend import MAX_SECONDS, SAMPLE_RATE, VIDEO_FPS


def _load() -> ctypes.CDLL:
    lib = native_build.load("wavio")
    lib.wavio_decode.restype = ctypes.c_int64
    lib.wavio_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_int64, ctypes.c_int32]
    lib.wavio_frame.restype = ctypes.c_int64
    lib.wavio_frame.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
                                ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int16)]
    return lib


def available() -> bool:
    """True once the library is built and loaded: a failed build raises, it
    does not return False."""
    _load()
    return True


def read_wav_native(path: str, target_sr: int = SAMPLE_RATE,
                    max_seconds: int = 600) -> Tuple[np.ndarray, int]:
    lib = _load()
    buf = np.empty(max_seconds * target_sr, np.float32)
    n = lib.wavio_decode(str(path).encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         buf.shape[0], target_sr)
    if n < 0:
        raise ValueError(f"wavio_decode failed with code {n} for {str(path)!r}")
    return buf[:n].copy(), target_sr


def frame_audio_native(wav: np.ndarray, sr: int = SAMPLE_RATE, fps: int = VIDEO_FPS,
                       max_seconds: int = MAX_SECONDS) -> np.ndarray:
    lib = _load()
    wav = np.ascontiguousarray(wav, np.float32)
    spf = sr // fps
    max_frames = min(len(wav), (max_seconds or 10 ** 9) * sr) // spf
    out = np.empty((max_frames, spf), np.int16)
    n = lib.wavio_frame(wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(wav), sr, fps,
                        max_seconds or 0, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    return out[:n]
