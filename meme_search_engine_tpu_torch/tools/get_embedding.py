"""One-shot embedding CLI (reference: src/get_embedding.py).

Sends an image file or text to the embedding server, writes the fp16
embedding to a file and prints it urlsafe-base64 (the frontend's ?e=
permalink format, App.svelte:303-333).

Usage:
  python -m meme_search_engine_tpu_torch.tools.get_embedding \
      --server http://localhost:1708 [--image x.png | --text "query"] \
      [--output emb.bin]

A copy of ``meme_search_engine_tpu/tools/get_embedding.py``, which the port
keeps rather than imports; ``msgpack`` is imported where it is used. The
server is the port's clip server (or any wire-compatible one).
"""

from __future__ import annotations

import argparse
import base64
import urllib.request


def main(argv=None):
    import msgpack

    ap = argparse.ArgumentParser()
    ap.add_argument("--server", default="http://localhost:1708")
    ap.add_argument("--image")
    ap.add_argument("--text")
    ap.add_argument("--output")
    args = ap.parse_args(argv)

    if args.image:
        with open(args.image, "rb") as f:
            payload = {"images": [f.read()]}
    elif args.text is not None:
        payload = {"text": [args.text]}
    else:
        ap.error("--image or --text required")

    req = urllib.request.Request(
        args.server + "/",
        data=msgpack.packb(payload),
        headers={"Content-Type": "application/msgpack"},
    )
    with urllib.request.urlopen(req) as resp:
        result = msgpack.unpackb(resp.read(), raw=False)
    emb = result[0]
    if args.output:
        with open(args.output, "wb") as f:
            f.write(emb)
    print(base64.urlsafe_b64encode(emb).decode())


if __name__ == "__main__":
    main()
