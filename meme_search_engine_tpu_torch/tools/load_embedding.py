"""Install a predefined ("slider") embedding from a permalink URL
(reference: load_embedding.py).

Takes a frontend embedding permalink (?e= urlsafe-b64 fp16) and stores
it under a name in the ingest database's predefined_embeddings table,
where the query server picks it up for the dropdown/sliders.

Usage:
  python -m meme_search_engine_tpu_torch.tools.load_embedding \
      --db state.db --name Meme --url "https://host/?e=AAAA..."

A copy of ``meme_search_engine_tpu/tools/load_embedding.py``, which the
port keeps rather than imports, over the port's ``ingest/db.py``.
"""

from __future__ import annotations

import argparse
import base64

from ..ingest.db import IngestDB
from ..utils.fp16 import decode_fp16_buffer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--db", required=True)
    ap.add_argument("--name", required=True)
    ap.add_argument("--url", required=True, help="permalink or raw b64")
    args = ap.parse_args(argv)

    b64 = args.url.split("?e=")[-1]
    pad = "=" * (-len(b64) % 4)
    data = base64.urlsafe_b64decode(b64 + pad)
    emb = decode_fp16_buffer(data)
    db = IngestDB(args.db)
    db.set_predefined_embedding(args.name, emb)
    print(f"stored '{args.name}' ({emb.shape[0]} dims)")


if __name__ == "__main__":
    main()
