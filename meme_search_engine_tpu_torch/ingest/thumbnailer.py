"""Thumbnail generation.

Format table and naming scheme mirror the reference so generated
thumbnail directories are interchangeable (src/main.rs:263-321 formats;
:221-242 naming = base64url(fnv1a64(filename)) + format name + ext;
:472-562 generation: Lanczos resize, skip when output would exceed the
original, binary-search JPEG quality to a 256KB target for `jpeg256kb`).

The standalone CLI equivalent of thumbnailer.py (ImageMagick/avifenc
pipeline) is `python -m meme_search_engine_tpu_torch.ingest.thumbnailer cfg`.

A copy of ``meme_search_engine_tpu/ingest/thumbnailer.py``, which the port keeps rather
than imports.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .filename import Actual, Filename, VideoFrame, encode_filename

__all__ = [
    "IMAGE_FORMATS",
    "ImageFormatConfig",
    "fnv1a64",
    "thumbnail_hash_key",
    "thumbnail_filename",
    "generate_thumbnails",
    "format_bitmask",
]


@dataclass(frozen=True)
class ImageFormatConfig:
    target_width: int
    quality: int
    pil_format: str
    extension: str
    target_filesize: int = 0
    is_fast: bool = True


# main.rs:263-321 — same five formats, same parameters
IMAGE_FORMATS: Dict[str, ImageFormatConfig] = {
    "jpegl": ImageFormatConfig(800, 70, "JPEG", "jpg"),
    "jpegh": ImageFormatConfig(1600, 80, "JPEG", "jpg"),
    "jpeg256kb": ImageFormatConfig(
        500, 0, "JPEG", "jpg", target_filesize=256_000, is_fast=False
    ),
    "avifh": ImageFormatConfig(1600, 80, "AVIF", "avif", is_fast=False),
    "avifl": ImageFormatConfig(800, 70, "AVIF", "avif", is_fast=False),
}

VIDEO_FORMAT_NAME = "VIDEO"  # synthetic format marking video containers


def fnv1a64(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for byte in data:
        h ^= byte
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def thumbnail_hash_key(filename) -> str:
    """base64url-no-pad fnv1a64 LE of the filename (main.rs:220-228).

    Rust's `Hash for str` feeds the bytes followed by a 0xff terminator
    into the hasher; replicated here byte-for-byte for `Actual` names so
    thumbnails generated by either implementation resolve identically.
    """
    import base64

    if isinstance(filename, VideoFrame):
        payload = encode_filename(filename)
    else:
        path = filename.path if isinstance(filename, Actual) else str(filename)
        payload = path.encode("utf-8") + b"\xff"
    h = fnv1a64(payload)
    return base64.urlsafe_b64encode(h.to_bytes(8, "little")).decode().rstrip("=")


def thumbnail_filename(filename, format_name: str) -> str:
    cfg = IMAGE_FORMATS[format_name]
    return f"{thumbnail_hash_key(filename)}{format_name}.{cfg.extension}"


def format_bitmask(format_names: List[str], all_formats: List[str]) -> int:
    """Pack per-item format availability into a u64 bitmask over the
    interned format-name table (main.rs:873-887)."""
    mask = 0
    for name in format_names:
        mask |= 1 << all_formats.index(name)
    return mask


def _encode(img, cfg: ImageFormatConfig) -> bytes:
    buf = io.BytesIO()
    img.save(buf, cfg.pil_format, quality=cfg.quality or 80)
    return buf.getvalue()


def _encode_to_size(img, cfg: ImageFormatConfig) -> bytes:
    """Binary-search JPEG quality until under target_filesize
    (main.rs:300-321 jpeg256kb semantics)."""
    lo, hi = 1, 95
    best = None
    while lo <= hi:
        q = (lo + hi) // 2
        buf = io.BytesIO()
        img.save(buf, cfg.pil_format, quality=q)
        data = buf.getvalue()
        if len(data) <= cfg.target_filesize:
            best = data
            lo = q + 1
        else:
            hi = q - 1
    return best if best is not None else data


def generate_thumbnails(
    filename: Filename,
    image,
    original_filesize: int,
    *,
    formats: Optional[Dict[str, ImageFormatConfig]] = None,
    fast_only: bool = False,
) -> Dict[str, Tuple[str, bytes]]:
    """PIL image -> {format_name: (thumb_filename, bytes)}.

    Skips outputs that would be larger than the original file
    (main.rs:527) — the original is served directly in that case.
    """
    from PIL import Image

    formats = formats or IMAGE_FORMATS
    out: Dict[str, Tuple[str, bytes]] = {}
    rgb = image.convert("RGB")
    for name, cfg in formats.items():
        if fast_only and not cfg.is_fast:
            continue
        if rgb.width > cfg.target_width:
            h = max(1, round(rgb.height * cfg.target_width / rgb.width))
            resized = rgb.resize((cfg.target_width, h), Image.Resampling.LANCZOS)
        else:
            resized = rgb
        try:
            data = (
                _encode_to_size(resized, cfg)
                if cfg.target_filesize
                else _encode(resized, cfg)
            )
        except Exception:
            continue  # encoder unavailable for this format
        if len(data) >= original_filesize and cfg.pil_format == "JPEG":
            continue
        out[name] = (thumbnail_filename(filename, name), data)
    return out


def main(argv=None):
    """Standalone batch thumbnailer (reference: thumbnailer.py).

    Config JSON: {"input": dir, "output": dir, "db_path": state db}.
    """
    import json
    import sqlite3
    import sys

    from PIL import Image

    argv = argv if argv is not None else sys.argv[1:]
    with open(argv[0]) as f:
        config = json.load(f)

    in_dir, out_dir = config["input"], config["output"]
    os.makedirs(out_dir, exist_ok=True)
    db = sqlite3.connect(config.get("db_path", os.path.join(out_dir, "thumbs.db")))
    db.execute(
        "CREATE TABLE IF NOT EXISTS thumb (file TEXT PRIMARY KEY, mtime REAL, formats TEXT)"
    )
    format_names: Dict[str, str] = {}
    for root, _dirs, files in os.walk(in_dir):
        for fn in files:
            path = os.path.join(root, fn)
            rel = os.path.relpath(path, in_dir)
            mtime = os.path.getmtime(path)
            row = db.execute(
                "SELECT mtime FROM thumb WHERE file=?", (rel,)
            ).fetchone()
            if row and row[0] >= mtime:
                continue
            try:
                with Image.open(path) as img:
                    thumbs = generate_thumbnails(
                        Actual(rel), img, os.path.getsize(path)
                    )
            except Exception as e:  # noqa: BLE001
                print(f"skip {rel}: {e}", file=sys.stderr)
                continue
            for name, (tn, data) in thumbs.items():
                with open(os.path.join(out_dir, tn), "wb") as f:
                    f.write(data)
                format_names[name] = IMAGE_FORMATS[name].extension
            db.execute(
                "INSERT OR REPLACE INTO thumb VALUES (?,?,?)",
                (rel, mtime, json.dumps(sorted(thumbs))),
            )
            db.commit()
    # formats.json consumed by the frontend (reference thumbnailer.py:125+)
    with open(os.path.join(out_dir, "formats.json"), "w") as f:
        json.dump(format_names, f)


if __name__ == "__main__":
    main()
