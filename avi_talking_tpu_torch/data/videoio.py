"""Video ingestion: an ffmpeg rawvideo pipe -> yuv420p frame chunks (port of
``avi_talking_tpu/data/videoio.py``; host logic, as in JAX).

An ``ffmpeg`` subprocess decodes to ``-pix_fmt yuv420p`` rawvideo on a
pipe, one fixed-size chunk of frames at a time; each frame's bytes are the
packed planar layout ``data.yuv`` sends to the device, so video-sourced
preprocessing does no host pixel conversion. ``probe_video`` reads the
geometry through ffprobe, or from ``ffmpeg -i``'s stderr where only ffmpeg
is installed. ffmpeg is looked up on PATH; without it the calls raise
``FfmpegMissingError`` naming the PNG-folder route, never skip.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
from typing import Iterator, Optional

import numpy as np


class FfmpegMissingError(RuntimeError):
    pass


def _require(tool: str) -> str:
    path = shutil.which(tool)
    if path is None:
        raise FfmpegMissingError(
            f"{tool} not found on PATH — video ingestion decodes containers "
            "through an ffmpeg rawvideo pipe. Install ffmpeg, or extract "
            "frames to PNG folders and use `preprocess-mead` on directories "
            "instead (the degraded path with no video decode).")
    return path


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


@dataclasses.dataclass(frozen=True)
class VideoInfo:
    width: int  # decoded (even) dimensions, after the pad-to-even filter
    height: int
    fps: float  # source average frame rate

    @property
    def frame_bytes(self) -> int:
        return self.width * self.height * 3 // 2


def _parse_rate(rate: str) -> float:
    if "/" in rate:
        num, den = rate.split("/")
        return float(num) / float(den) if float(den) else 0.0
    return float(rate)


def probe_video(path: str) -> VideoInfo:
    """Stream geometry via ffprobe (JSON); falls back to parsing
    ``ffmpeg -i`` stderr when only ffmpeg is installed. Dimensions are
    floored to even (yuv420p needs even planes; the decode filter crops the
    same single row/column)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    ffprobe = shutil.which("ffprobe")
    w = h = None
    fps = 25.0
    if ffprobe is not None:
        out = subprocess.run(
            [ffprobe, "-v", "error", "-select_streams", "v:0",
             "-show_entries", "stream=width,height,avg_frame_rate",
             "-of", "json", path],
            capture_output=True, text=True)
        if out.returncode == 0:
            try:
                st = json.loads(out.stdout)["streams"][0]
                w, h = int(st["width"]), int(st["height"])
                fps = _parse_rate(st.get("avg_frame_rate", "25/1")) or 25.0
            except (KeyError, IndexError, ValueError, json.JSONDecodeError):
                w = h = None
    if w is None:
        ffmpeg = _require("ffmpeg")
        out = subprocess.run([ffmpeg, "-i", path], capture_output=True,
                             text=True)  # rc != 0 (no output file) — fine
        m = re.search(r"Video:.*?\b(\d{2,5})x(\d{2,5})\b", out.stderr)
        if not m:
            raise RuntimeError(
                f"could not probe video geometry of {path} "
                f"(ffprobe missing and ffmpeg -i gave no Video line)")
        w, h = int(m.group(1)), int(m.group(2))
        mf = re.search(r"(\d+(?:\.\d+)?)\s*fps", out.stderr)
        if mf:
            fps = float(mf.group(1))
    return VideoInfo(width=w - w % 2, height=h - h % 2, fps=fps)


def _decode_cmd(path: str, info: VideoInfo, fps: Optional[float]) -> list:
    ffmpeg = _require("ffmpeg")
    filters = []
    if fps is not None:
        filters.append(f"fps={fps}")
    # real H.264/HEVC sources are almost always LIMITED range (Y 16-235)
    # and HD ones BT.709 — data.yuv reconstructs with the full-range BT.601
    # matrix, so normalise both here (otherwise every ingested frame would
    # be contrast-compressed and slightly hue-shifted)
    filters.append("scale=in_range=auto:out_range=full:"
                   "out_color_matrix=bt601")
    filters.append(f"crop={info.width}:{info.height}:0:0")  # even planes
    return [ffmpeg, "-v", "error", "-i", path, "-vf", ",".join(filters),
            "-f", "rawvideo", "-pix_fmt", "yuv420p", "-"]


def iter_video_yuv420(
    path: str,
    fps: Optional[float] = None,
    chunk: int = 32,
    info: Optional[VideoInfo] = None,
) -> Iterator[np.ndarray]:
    """Stream a video as packed yuv420p chunks: yields (n, H*W*3/2) uint8
    arrays (n <= ``chunk``), the exact row layout ``data.yuv`` and
    ``EmocaPreprocessor(transport='yuv420')`` consume. ``fps`` resamples
    to a fixed frame rate (the reference's 25 fps contract); None keeps
    the source rate. Host memory stays bounded at one chunk regardless of
    clip length or resolution."""
    import tempfile

    info = info or probe_video(path)
    fsz = info.frame_bytes
    # stderr to a temp FILE, not a pipe: an un-drained stderr pipe fills
    # its ~64 KB buffer on decoder-error spam and deadlocks the stdout read
    errf = tempfile.TemporaryFile()
    proc = subprocess.Popen(_decode_cmd(path, info, fps),
                            stdout=subprocess.PIPE, stderr=errf)
    assert proc.stdout is not None
    eof = False
    try:
        while True:
            want = fsz * chunk
            buf = bytearray()
            while len(buf) < want:
                piece = proc.stdout.read(want - len(buf))
                if not piece:
                    break
                buf += piece
            n_full = len(buf) // fsz
            if n_full:
                yield np.frombuffer(
                    bytes(buf[: n_full * fsz]), np.uint8).reshape(n_full, fsz)
            if len(buf) < want:
                eof = True
                break
    finally:
        proc.stdout.close()
        rc = proc.wait()
        errf.seek(0)
        err = errf.read()
        errf.close()
        # raise on any nonzero exit ONCE the stream ended naturally — a
        # killed decoder (e.g. OOM, rc=-9, empty stderr) must not pass off
        # a truncated clip as complete. A consumer that stopped iterating
        # early (eof False) killed ffmpeg itself via SIGPIPE: not an error.
        if eof and rc not in (0, None):
            raise RuntimeError(
                f"ffmpeg decode of {path} failed (rc={rc}): "
                f"{err.decode(errors='replace')[:500] or 'no stderr'}")


def read_video_frames(
    path: str, fps: Optional[float] = None, info: Optional[VideoInfo] = None
) -> np.ndarray:
    """Whole-clip convenience: (T, H, W, 3) uint8 RGB (host yuv->rgb; for
    long/high-res clips prefer the streaming ``iter_video_yuv420``)."""
    from .yuv import yuv420_to_rgb_host

    info = info or probe_video(path)
    chunks = [
        np.clip(np.rint(yuv420_to_rgb_host(
            c, info.height, info.width) * 255.0), 0, 255).astype(np.uint8)
        for c in iter_video_yuv420(path, fps=fps, info=info)
    ]
    if not chunks:
        return np.zeros((0, info.height, info.width, 3), np.uint8)
    return np.concatenate(chunks)


def extract_wav(path: str, out_wav: str, sample_rate: int = 16_000) -> bool:
    """Demux + resample the audio track to mono 16 kHz wav (the
    reference's scripts/audio.sh / proc_rvd_wav.py job). Returns False
    (and prints a loud note) when the container has no audio."""
    ffmpeg = _require("ffmpeg")
    out = subprocess.run(
        [ffmpeg, "-v", "error", "-y", "-i", path, "-vn", "-ac", "1",
         "-ar", str(sample_rate), "-f", "wav", out_wav],
        capture_output=True, text=True)
    if out.returncode != 0 or not os.path.exists(out_wav) or \
            os.path.getsize(out_wav) <= 44:
        print(f"[videoio] no audio extracted from {path}: "
              f"{out.stderr.strip()[:200] or 'empty stream'}")
        if os.path.exists(out_wav):
            os.remove(out_wav)
        return False
    return True
