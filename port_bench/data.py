"""Everything a run feeds both sides, made from ``--seed``.

The program and the reference (``reference/``) each call these functions
for their own copy: the same seed gives the same weights and pictures
on the same device. Nothing here imports the port.

- :func:`siglip_params`: SigLIP's two towers in the source layout that
  ``EmbeddingEngine`` takes (nested dicts of stacked per-layer tensors),
  drawn on ``device`` by one ``torch.randn`` call and cut into leaves.
- :func:`smooth_images`: uint8 pictures (a seeded smooth field plus noise),
  drawn on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["sub_seed", "siglip_spec", "siglip_params", "smooth_images"]


def sub_seed(seed: int, name: str) -> int:
    """A 63-bit seed for one stream of a run (``--seed`` may pass 32 bits)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, *name.encode()]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def _blocks_spec(depth, width, mlp):
    lead = (depth,)
    spec = [(("ln1", "g"), (*lead, width), "gain"), (("ln1", "b"), (*lead, width), "bias")]
    for n in ("q", "k", "v", "o"):
        spec += [(("attn", n, "w"), (*lead, width, width), "dense"),
                 (("attn", n, "b"), (*lead, width), "bias")]
    spec += [(("ln2", "g"), (*lead, width), "gain"), (("ln2", "b"), (*lead, width), "bias"),
             (("mlp", "fc1", "w"), (*lead, width, mlp), "dense"),
             (("mlp", "fc1", "b"), (*lead, mlp), "bias"),
             (("mlp", "fc2", "w"), (*lead, mlp, width), "dense"),
             (("mlp", "fc2", "b"), (*lead, width), "bias")]
    return spec


def siglip_spec(m: dict) -> list:
    """(path, shape, kind) of every leaf of both towers; kinds: ``dense``
    (std 1/sqrt(fan in)), ``emb`` (std 0.02), ``bias`` (std 0.02),
    ``gain`` (1 + 0.02 noise)."""
    w, tw = m["width"], m["text_width"]
    patch = m["patch_size"] ** 2 * 3
    n_patch = (m["image_size"] // m["patch_size"]) ** 2
    img = [(("patch_embed", "w"), (patch, w), "dense"), (("patch_embed", "b"), (w,), "bias"),
           (("pos_emb",), (n_patch, w), "emb")]
    img += [(("blocks", *p), s, k) for p, s, k in _blocks_spec(m["depth"], w, m["mlp_dim"])]
    img += [(("ln_final", "g"), (w,), "gain"), (("ln_final", "b"), (w,), "bias"),
            (("map_head", "probe"), (1, w), "emb")]
    for n in ("q", "k", "v", "o"):
        img += [(("map_head", n, "w"), (w, w), "dense"), (("map_head", n, "b"), (w,), "bias")]
    img += [(("map_head", "ln", "g"), (w,), "gain"), (("map_head", "ln", "b"), (w,), "bias"),
            (("map_head", "mlp", "fc1", "w"), (w, m["mlp_dim"]), "dense"),
            (("map_head", "mlp", "fc1", "b"), (m["mlp_dim"],), "bias"),
            (("map_head", "mlp", "fc2", "w"), (m["mlp_dim"], w), "dense"),
            (("map_head", "mlp", "fc2", "b"), (w,), "bias")]
    txt = [(("token_emb",), (m["vocab_size"], tw), "emb"),
           (("pos_emb",), (m["text_len"], tw), "emb")]
    txt += [(("blocks", *p), s, k)
            for p, s, k in _blocks_spec(m["text_depth"], tw, m["text_mlp_dim"])]
    txt += [(("ln_final", "g"), (tw,), "gain"), (("ln_final", "b"), (tw,), "bias"),
            (("head", "w"), (tw, m["d_emb"]), "dense"), (("head", "b"), (m["d_emb"],), "bias")]
    return [(("img", *p), s, k) for p, s, k in img] + [(("txt", *p), s, k) for p, s, k in txt]


def siglip_params(m: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Both towers from ``seed`` on ``device`` in ``dtype`` (the served
    type), plus the loss scalars ``t`` and ``b``. One ``randn`` draws every
    leaf's numbers; each leaf is scaled from its slice into a tensor of
    its own, so nothing keeps the draw alive."""
    spec = siglip_spec(m)
    sizes = [int(np.prod(s)) for _, s, _ in spec]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    tree: dict = {}
    off = 0
    for (path, shape, kind), n in zip(spec, sizes):
        x = flat[off:off + n].view(shape)
        off += n
        if kind == "dense":
            x = x * (1.0 / shape[-2]) ** 0.5
        elif kind == "gain":
            x = 1.0 + 0.02 * x
        else:
            x = 0.02 * x
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x.to(dtype).contiguous()
    del flat
    tree["t"] = torch.tensor(float(np.log(10.0)), dtype=torch.float32, device=device)
    tree["b"] = torch.tensor(-10.0, dtype=torch.float32, device=device)
    return tree


def smooth_images(n: int, height: int, width: int, seed: int, device, cells: int = 6,
                  noise: float = 24.0) -> torch.Tensor:
    """(n, height, width, 3) uint8 on ``device``: per picture a random
    colour field on a ``cells`` x ``cells`` grid, bilinear to full size,
    plus seeded noise of ``noise`` levels, so JPEG compresses it as it
    would a photo and no two pictures are alike."""
    gen = torch.Generator(device=device).manual_seed(seed)
    coarse = torch.rand(n, 3, cells, cells, generator=gen, device=device) * 255.0
    field = torch.nn.functional.interpolate(coarse, size=(height, width), mode="bilinear",
                                            align_corners=True)
    field = field + noise * (torch.rand(n, 3, height, width, generator=gen, device=device) - 0.5)
    return field.clamp_(0, 255).round_().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
