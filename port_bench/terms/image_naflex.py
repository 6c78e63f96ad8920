"""Pictures at their own aspect ratios, each handed over at its SigLIP 2
NaFlex grid's size as uint8 (P h, P w, 3): what the clip server's decode
pool hands the engine after resizing, and what
``EmbeddingEngine.embed_image_list`` takes.

Each picture's native aspect h / w is log-uniform in [``aspect_min``,
``aspect_max``] and its long side uniform in [``long_min``,
``long_max``] px; its grid is the processor's rule at the model's patch
and ``max_num_patches`` (``reference/siglip2.grid_for``; the mix's own
``max_num_patches`` for a model without one). The pixels are a
seeded smooth colour field plus noise (``data.smooth_images``), drawn on
the card in one call per grid; no two are alike.
"""

from collections import defaultdict

import numpy as np

from port_bench import data
from port_bench.reference.siglip2 import grid_for

TOWER = "img"
ENGINE_CALL = "embed_image_list"


def grids(spec: dict, n: int, seed: int, model: dict) -> list:
    """The n pictures' grids (h, w), from the seed."""
    rng = np.random.default_rng(data.sub_seed(seed, "naflex-sizes"))
    aspect = np.exp(rng.uniform(np.log(spec["aspect_min"]), np.log(spec["aspect_max"]), n))
    long = rng.uniform(spec["long_min"], spec["long_max"], n)
    out = []
    for a, side in zip(aspect, long):
        h, w = (side, side / a) if a >= 1 else (side * a, side)
        out.append(grid_for(max(1, round(h)), max(1, round(w)), model["patch_size"],
                            model.get("max_num_patches") or spec["max_num_patches"]))
    return out


def draw(spec: dict, n: int, seed: int, model: dict, device) -> list:
    p = model["patch_size"]
    shapes = grids(spec, n, seed, model)
    where = defaultdict(list)
    for i, g in enumerate(shapes):
        where[g].append(i)
    out: list = [None] * n
    for (h, w), rows in sorted(where.items()):
        pics = data.smooth_images(len(rows), p * h, p * w, data.sub_seed(seed, f"grid-{h}x{w}"),
                                  device, cells=spec["cells"], noise=spec["noise"]).cpu().numpy()
        for i, pic in zip(rows, pics):
            out[i] = pic
    return out


def engine_input(inputs) -> list:
    return list(inputs)


def reference(params: dict, inputs, model: dict, precision: str, device):
    from port_bench.reference import siglip2

    return siglip2.encode_pictures(params, list(inputs), model, precision)
