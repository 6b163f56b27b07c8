"""Host-side audio frontend: wav decode -> 16 kHz int16 -> (T, 640) frames.

A numpy copy of ``avi_talking_tpu/audio/frontend.py`` (the port imports
nothing of the JAX package); the int16 cast with its wrap and the zero
padding to ``pad_to_multiple`` are kept as they are there.

Mirrors the reference's ``read_audio``/``process_audio`` (inferno's
TalkingHead ``evaluation_functions.py``): float wav * 32768 -> int16, hard cut at ``max_seconds`` (22 s), reshape into
25 fps frames of 640 samples. Decoding uses the stdlib ``wave`` module plus
scipy polyphase resampling (librosa/ffmpeg are heavier host deps the
framework does not require).

Everything here is numpy on host. The device sees one float32 array per
utterance (zero-mean/unit-var normalised like Wav2Vec2Processor).
"""

from __future__ import annotations

import wave
from typing import Optional, Tuple

import numpy as np

SAMPLE_RATE = 16_000
VIDEO_FPS = 25
SAMPLES_PER_FRAME = SAMPLE_RATE // VIDEO_FPS  # 640
MAX_SECONDS = 22


def read_wav(path: str, target_sr: int = SAMPLE_RATE) -> Tuple[np.ndarray, int]:
    """Decode a PCM wav file to mono float32 in [-1, 1] at ``target_sr``."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported wav sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    if sr != target_sr:
        from scipy.signal import resample_poly
        from math import gcd

        g = gcd(target_sr, sr)
        data = resample_poly(data, target_sr // g, sr // g).astype(np.float32)
        sr = target_sr
    return data, sr


def frame_audio(
    wavdata: np.ndarray,
    sampling_rate: int = SAMPLE_RATE,
    video_fps: int = VIDEO_FPS,
    max_seconds: Optional[int] = MAX_SECONDS,
    pad_to_multiple: int = 1,
) -> np.ndarray:
    """float wav -> int16 -> (T, samples_per_frame) frames at ``video_fps``.

    Follows process_audio semantics: T = floor(len / spf) (tail dropped),
    then zero-padded so T is a multiple of ``pad_to_multiple``
    (create_base_sample pads to the squasher's smallest unit).
    """
    assert sampling_rate % video_fps == 0
    spf = sampling_rate // video_fps
    x = (wavdata.astype(np.float64) * 32768.0).astype(np.int16)
    if max_seconds is not None and x.shape[0] > max_seconds * sampling_rate:
        x = x[: max_seconds * sampling_rate]
    t = x.shape[0] // spf
    frames = np.zeros((t, spf), dtype=np.int16)
    flat = frames.reshape(-1)
    m = min(x.size, flat.size)
    flat[:m] = x[:m]
    frames = flat.reshape(t, spf)
    if pad_to_multiple > 1 and t % pad_to_multiple:
        pad = pad_to_multiple - t % pad_to_multiple
        frames = np.concatenate(
            [frames, np.zeros((pad, spf), dtype=frames.dtype)], axis=0
        )
    return frames


def normalize_audio(frames: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Wav2Vec2Processor-style per-utterance zero-mean/unit-variance."""
    flat = frames.astype(np.float32).reshape(-1)
    return ((flat - flat.mean()) / np.sqrt(flat.var() + eps)).astype(np.float32)
