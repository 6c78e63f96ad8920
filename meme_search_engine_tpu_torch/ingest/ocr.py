"""OCR via the Google Lens private API (reference: src/ocr.rs, ocr.py).

Tall images are sliced into <=1024px strips (ocr.rs:136-175 chunks at
1024, ocr.py:71-79 at 1000), each strip is uploaded as multipart
form data, and the ``AF_initDataCallback`` JSON blob in the response is
parsed for text segments with region coordinates (ocr.rs:50-133).

The network call obviously requires egress; environments without it can
plug any callable ``(png_bytes) -> [(text, (x,y,w,h))...]`` as the
``backend`` argument (used by tests).

A copy of ``meme_search_engine_tpu/ingest/ocr.py``, which the port keeps rather
than imports.
"""

from __future__ import annotations

import io
import json
import re
import time
from typing import Callable, List, Optional, Tuple

__all__ = ["chunk_image", "scan_chunks", "ocr_image", "lens_backend"]

MAX_CHUNK_HEIGHT = 1024  # ocr.rs:136
Segment = Tuple[str, Tuple[float, float, float, float]]


def chunk_image(image) -> List:
    """Split a PIL image into vertical strips of height <= 1024px.

    Google Lens rejects very tall images; the reference scans memes (often
    tall screenshot stacks) strip by strip and merges segments.
    """
    chunks = []
    y = 0
    while y < image.height:
        h = min(MAX_CHUNK_HEIGHT, image.height - y)
        chunks.append((y, image.crop((0, y, image.width, y + h))))
        y += h
    return chunks


def scan_chunks(image, backend: Callable[[bytes], List[Segment]]) -> List[Segment]:
    """Run the backend per strip and merge with y-offset correction."""
    segments: List[Segment] = []
    for y_off, chunk in chunk_image(image):
        buf = io.BytesIO()
        chunk.save(buf, "PNG")
        for text, (x, y, w, h) in backend(buf.getvalue()):
            segments.append((text, (x, y + y_off, w, h)))
    return segments


def ocr_image(image, backend: Optional[Callable] = None) -> Tuple[str, List[Segment]]:
    """Full-image OCR -> (joined text, raw segments).

    Images wider than 1024px are downscaled to width 1024 first
    (ocr.rs:140-146, CatmullRom there, bicubic here); segment
    coordinates refer to the resized image, as in the reference.
    """
    backend = backend or lens_backend
    if image.width > MAX_CHUNK_HEIGHT:
        from PIL import Image

        nh = max(1, round(image.height * MAX_CHUNK_HEIGHT / image.width))
        image = image.resize((MAX_CHUNK_HEIGHT, nh), Image.BICUBIC)
    segments = scan_chunks(image, backend)
    text = "\n".join(s[0] for s in segments)
    return text, segments


_CALLBACK_RE = re.compile(r"AF_initDataCallback\((\{key: 'ds:1'.*?\})\);", re.S)


def _js_to_json(blob: str) -> str:
    """The AF_initDataCallback argument is JS, not strict JSON: bare
    object keys (``key:``, ``data:``) and single-quoted strings. A
    char-level scan converts both without mangling apostrophes inside
    double-quoted strings (real OCR text contains them)."""
    out: List[str] = []
    i, n = 0, len(blob)
    while i < n:
        c = blob[i]
        if c == '"':
            j = i + 1
            while j < n and blob[j] != '"':
                j += 2 if blob[j] == "\\" else 1
            out.append(blob[i : j + 1])
            i = j + 1
        elif c == "'":
            j = i + 1
            buf: List[str] = []
            while j < n and blob[j] != "'":
                if blob[j] == "\\":
                    # JSON has no \' escape; unwrap it
                    nxt = blob[j + 1] if j + 1 < n else ""
                    buf.append("'" if nxt == "'" else blob[j : j + 2])
                    j += 2
                else:
                    buf.append('\\"' if blob[j] == '"' else blob[j])
                    j += 1
            out.append('"' + "".join(buf) + '"')
            i = j + 1
        elif c.isalpha() or c == "_":
            j = i
            while j < n and (blob[j].isalnum() or blob[j] == "_"):
                j += 1
            word = blob[i:j]
            k = j
            while k < n and blob[k] in " \t\r\n":
                k += 1
            if k < n and blob[k] == ":" and word not in ("true", "false", "null"):
                out.append(f'"{word}"')
            else:
                out.append(word)
            i = j
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_lens_response(
    html: str, image_w: int, image_h: int
) -> List[Segment]:
    """Extract text segments from the AF_initDataCallback payload,
    matching the reference's structural parse exactly (ocr.rs:50-133):

    - segment strings live at ``data[3][4][0][0]``
    - regions live at ``data[2][3][0]``; a region applies iff its
      element 11 is a string starting with ``"text:"``, and its element
      1 holds ``[center_x, center_y, width, height]`` as fractions of
      the chunk dimensions (rationalize_coords_format1, ocr.rs:33-46)
    - segments and qualifying regions zip positionally

    Returns [] on any missing/shifted structure (the reference errors;
    callers here treat a chunk with no parse as no text).
    """
    m = _CALLBACK_RE.search(html)
    if not m:
        return []
    try:
        data = json.loads(_js_to_json(m.group(1)))
    except json.JSONDecodeError:
        return []
    if not isinstance(data, dict) or "errorHasStatus" in data:
        return []
    root = data.get("data")
    try:
        segs_raw = root[3][4][0][0]
        regions_raw = root[2][3][0]
    except (TypeError, IndexError, KeyError):
        return []
    if not isinstance(segs_raw, list) or not isinstance(regions_raw, list):
        return []

    coords: List[Tuple[float, float, float, float]] = []
    for region in regions_raw:
        try:
            tag = region[11]
            if not (isinstance(tag, str) and tag.startswith("text:")):
                continue
            cxf, cyf, wf, hf = (float(v) for v in region[1][:4])
        except (TypeError, IndexError, ValueError):
            continue
        coords.append(
            (
                round((cxf - wf / 2.0) * image_w),
                round((cyf - hf / 2.0) * image_h),
                round(wf * image_w),
                round(hf * image_h),
            )
        )
    return [
        (text, xywh)
        for text, xywh in zip(segs_raw, coords)
        if isinstance(text, str)
    ]


def lens_backend(png_bytes: bytes, timeout: float = 30.0) -> List[Segment]:
    """POST one image strip to Google Lens and parse segments.

    Requires network egress. Uses urllib to avoid a hard aiohttp
    dependency in batch tools.
    """
    import urllib.request
    import uuid

    boundary = uuid.uuid4().hex
    body = (
        (
            f"--{boundary}\r\n"
            'Content-Disposition: form-data; name="encoded_image"; '
            'filename="image.png"\r\nContent-Type: image/png\r\n\r\n'
        ).encode()
        + png_bytes
        + f"\r\n--{boundary}--\r\n".encode()
    )
    url = (
        "https://lens.google.com/v3/upload?stcs="
        + str(int(time.time() * 1000))
    )
    req = urllib.request.Request(
        url,
        data=body,
        headers={
            "Content-Type": f"multipart/form-data; boundary={boundary}",
            "User-Agent": "Mozilla/5.0 (X11; Linux x86_64; rv:109.0)",
        },
    )
    from PIL import Image

    with Image.open(io.BytesIO(png_bytes)) as im:
        w, h = im.size
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return _parse_lens_response(
            resp.read().decode("utf-8", "replace"), w, h
        )
