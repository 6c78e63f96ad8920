"""Video frame extraction for indexing.

The reference decodes the best video stream through ffmpeg with a
``scale -> thumbnail(n=interval*fps) -> select(scene>0.05 or first)``
filtergraph and feeds RGB frames to a callback (src/video_reader.rs:9-79);
each kept frame becomes a synthetic ``VideoFrame(container, n)`` document
(src/main.rs:387-427).

Two backends implement those filtergraph semantics here:

- **OpenCV** (primary; bundled ffmpeg demuxers, no external binary):
  frames are windowed into ``interval*fps`` groups, each window's most
  histogram-representative frame is picked (the ``thumbnail`` filter's
  rule), then a normalised-SAD scene score against the previously kept
  frame gates emission (the ``select=gt(scene,0.05)+eq(n,0)`` rule).
- **ffmpeg CLI** (fallback when installed): the literal filtergraph
  over a rawvideo pipe.

A copy of ``meme_search_engine_tpu/ingest/video.py``, which the port keeps rather
than imports.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["ffmpeg_available", "video_available", "extract_frames"]

SCENE_THRESHOLD = 0.05  # video_reader.rs select filter
DEFAULT_INTERVAL_S = 5.0


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None and shutil.which("ffprobe") is not None


def _cv2():
    try:
        import cv2

        return cv2
    except ImportError:  # pragma: no cover
        return None


def video_available() -> bool:
    """Any decode backend present?"""
    return _cv2() is not None or ffmpeg_available()


def _probe(path: str) -> Optional[Tuple[int, int, float]]:
    """(width, height, fps) of the best video stream."""
    try:
        out = subprocess.run(
            [
                "ffprobe", "-v", "error", "-select_streams", "v:0",
                "-show_entries", "stream=width,height,r_frame_rate",
                "-of", "csv=p=0", path,
            ],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
        w, h, rate = out.split(",")[:3]
        num, _, den = rate.partition("/")
        fps = float(num) / float(den or 1)
        return int(w), int(h), fps
    except Exception:  # noqa: BLE001
        return None


def _scene_score(a: np.ndarray, b: np.ndarray) -> float:
    """ffmpeg scene-change score: mean absolute difference / 255."""
    return float(
        np.mean(np.abs(a.astype(np.int16) - b.astype(np.int16)))
    ) / 255.0


def _pick_thumbnail(window: List[np.ndarray]) -> int:
    """ffmpeg ``thumbnail`` filter rule: the frame whose histogram is
    closest to the window's average histogram."""
    if len(window) == 1:
        return 0
    hists = []
    for f in window:
        h = np.concatenate(
            [np.bincount(f[..., c].ravel() >> 2, minlength=64) for c in range(3)]
        ).astype(np.float64)
        hists.append(h / h.sum())
    avg = np.mean(hists, axis=0)
    errs = [np.sum((h - avg) ** 2) for h in hists]
    return int(np.argmin(errs))


def _extract_frames_cv2(
    path: str, max_dim: Optional[int], interval_s: float
) -> Iterator[np.ndarray]:
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"could not open video {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    if not np.isfinite(fps) or fps <= 0:
        fps = 30.0
    n_thumb = max(1, round(interval_s * fps))

    # ffmpeg's select=gt(scene,0.05) scores each thumbnail frame against
    # the PREVIOUS THUMBNAIL frame regardless of whether that one was
    # selected, so on slowly drifting content consecutive below-threshold
    # deltas never accumulate into an emission. Track prev_thumb (the
    # last candidate), not the last emitted frame.
    prev_thumb = None
    window: List[np.ndarray] = []
    try:
        while True:
            ok, frame = cap.read()
            if ok:
                frame = frame[..., ::-1]  # BGR -> RGB
                if max_dim and max(frame.shape[:2]) > max_dim:
                    scale = max_dim / max(frame.shape[:2])
                    nw = max(2, int(frame.shape[1] * scale) // 2 * 2)
                    nh = max(2, int(frame.shape[0] * scale) // 2 * 2)
                    frame = cv2.resize(
                        frame, (nw, nh), interpolation=cv2.INTER_AREA
                    )
                window.append(np.ascontiguousarray(frame))
            if window and (len(window) == n_thumb or not ok):
                cand = window[_pick_thumbnail(window)]
                window.clear()
                emit = (
                    prev_thumb is None
                    or _scene_score(prev_thumb, cand) > SCENE_THRESHOLD
                )
                prev_thumb = cand
                if emit:
                    yield cand
            if not ok:
                break
    finally:
        cap.release()


def _extract_frames_ffmpeg(
    path: str, max_dim: Optional[int], interval_s: float
) -> Iterator[np.ndarray]:
    probed = _probe(path)
    if probed is None:
        raise RuntimeError(f"could not probe video {path}")
    w, h, fps = probed
    if max_dim and max(w, h) > max_dim:
        scale = max_dim / max(w, h)
        w, h = int(w * scale) // 2 * 2, int(h * scale) // 2 * 2

    n_thumb = max(1, round(interval_s * fps))
    vf = (
        f"scale={w}:{h},thumbnail=n={n_thumb},"
        f"select=gt(scene\\,{SCENE_THRESHOLD})+eq(n\\,0)"
    )
    proc = subprocess.Popen(
        [
            "ffmpeg", "-v", "error", "-i", path, "-vf", vf,
            "-vsync", "vfr", "-f", "rawvideo", "-pix_fmt", "rgb24", "-",
        ],
        stdout=subprocess.PIPE,
    )
    frame_bytes = w * h * 3
    try:
        while True:
            data = proc.stdout.read(frame_bytes)
            if len(data) < frame_bytes:
                break
            yield np.frombuffer(data, np.uint8).reshape(h, w, 3)
    finally:
        proc.stdout.close()
        proc.wait()


def extract_frames(
    path: str,
    *,
    max_dim: Optional[int] = None,
    interval_s: float = DEFAULT_INTERVAL_S,
    backend: str = "auto",
) -> Iterator[np.ndarray]:
    """Yield scene-representative RGB frames as uint8 (H, W, 3) arrays."""
    if backend == "auto":
        backend = "cv2" if _cv2() is not None else "ffmpeg"
    if backend == "cv2":
        return _extract_frames_cv2(path, max_dim, interval_s)
    if not ffmpeg_available():
        raise RuntimeError("no video backend (cv2/ffmpeg) available")
    return _extract_frames_ffmpeg(path, max_dim, interval_s)
