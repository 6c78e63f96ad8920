"""File content hash for the scraper discard list (reference:
genseahash.py — prints a 64-bit content hash used by reddit_dump's
seen-content filter).

A copy of ``meme_search_engine_tpu/tools/content_hash.py``, which the port
keeps rather than imports; the scraper's discard list reads the same
digests.

Usage: python -m meme_search_engine_tpu_torch.tools.content_hash file [file...]
"""

from __future__ import annotations

import hashlib
import sys


def content_hash(data: bytes) -> int:
    """Stable 64-bit digest (blake2b-8; the reference uses seahash — any
    stable 64-bit hash serves the discard-list role)."""
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "little"
    )


def main(argv=None):
    for path in argv if argv is not None else sys.argv[1:]:
        with open(path, "rb") as f:
            print(content_hash(f.read()), path)


if __name__ == "__main__":
    main()
