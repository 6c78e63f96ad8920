"""Text lines -> fp16 query embedding file (reference:
generate_queries_bin.py).

Feeds query-aware OPQ training and OOD graph builds: one embedding per
input line, concatenated as raw LE fp16 into the output file.

A copy of ``meme_search_engine_tpu/tools/generate_queries_bin.py``, which
the port keeps rather than imports; ``msgpack`` is imported where it is
used.

Usage:
  python -m meme_search_engine_tpu_torch.tools.generate_queries_bin \
      --server http://localhost:1708 --input queries.txt \
      --output query_data.bin [--batch 64]
"""

from __future__ import annotations

import argparse
import urllib.request


def main(argv=None):
    import msgpack

    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="http://localhost:1708")
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)

    with open(args.input) as f:
        lines = [line.strip() for line in f if line.strip()]

    with open(args.output, "wb") as out:
        for i in range(0, len(lines), args.batch):
            chunk = lines[i : i + args.batch]
            req = urllib.request.Request(
                args.server + "/",
                data=msgpack.packb({"text": chunk}),
                headers={"Content-Type": "application/msgpack"},
            )
            with urllib.request.urlopen(req) as resp:
                for emb in msgpack.unpackb(resp.read(), raw=False):
                    out.write(emb)
            print(f"{min(i + args.batch, len(lines))}/{len(lines)}")


if __name__ == "__main__":
    main()
