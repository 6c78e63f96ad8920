"""Per-dimension embedding distribution heatmap (reference:
diskann/vec_dist.py).

Writes an SVG heatmap of per-dimension value histograms — used to sanity
check quantizer clipping ranges.

A copy of ``meme_search_engine_tpu/tools/vec_dist.py``, which the port
keeps rather than imports (numpy only).

Usage:
  python -m meme_search_engine_tpu_torch.tools.vec_dist \
      --vectors emb.bin --d-emb 1152 --output dist.svg
"""

from __future__ import annotations

import argparse

import numpy as np


def histogram_heatmap_svg(
    data: np.ndarray, n_bins: int = 64, width: int = 1200, height: int = 400
) -> str:
    """(N, D) -> SVG string; columns = dimensions, rows = value bins."""
    d = data.shape[1]
    lo, hi = np.quantile(data, [0.001, 0.999])
    hists = np.stack(
        [np.histogram(data[:, j], bins=n_bins, range=(lo, hi))[0] for j in range(d)]
    ).T  # (bins, D)
    hists = hists / max(1, hists.max())
    cw, ch = width / d, height / n_bins
    cells = []
    for i in range(n_bins):
        for j in range(d):
            v = hists[n_bins - 1 - i, j]
            if v <= 0:
                continue
            shade = int(255 * (1 - v))
            cells.append(
                f'<rect x="{j*cw:.2f}" y="{i*ch:.2f}" width="{cw:.2f}" '
                f'height="{ch:.2f}" fill="rgb({shade},{shade},255)"/>'
            )
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}">' + "".join(cells) + "</svg>"
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--vectors", required=True)
    ap.add_argument("--d-emb", type=int, default=1152)
    ap.add_argument("--output", default="dist.svg")
    ap.add_argument("--sample", type=int, default=50000)
    args = ap.parse_args(argv)

    data = (
        np.fromfile(args.vectors, np.float16)
        .reshape(-1, args.d_emb)[: args.sample]
        .astype(np.float32)
    )
    with open(args.output, "w") as f:
        f.write(histogram_heatmap_svg(data))
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
