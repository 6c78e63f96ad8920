"""Pictures already at the model's resolution, as uint8 (R, R, 3) arrays:
what the clip server's worker hands the engine after decoding, and what
``EmbeddingEngine.embed_image_arrays`` takes.

Each is a seeded smooth colour field (bilinear from ``cells`` x ``cells``)
plus seeded noise of ``noise`` levels (``data.smooth_images``), drawn on
the card in one call; no two are alike.
"""

import numpy as np

from port_bench import data

TOWER = "img"
ENGINE_CALL = "embed_image_arrays"


def draw(spec: dict, n: int, seed: int, model: dict, device) -> np.ndarray:
    r = model["image_size"]
    pics = data.smooth_images(n, r, r, seed, device, cells=spec["cells"], noise=spec["noise"])
    return pics.cpu().numpy()


def engine_input(inputs) -> np.ndarray:
    return np.ascontiguousarray(inputs)


def reference(params: dict, inputs, model: dict, precision: str, device):
    import torch

    from port_bench.reference import siglip

    x = torch.from_numpy(np.ascontiguousarray(np.stack(list(inputs)))).to(device)
    return siglip.encode_image(params, x, model, precision)
