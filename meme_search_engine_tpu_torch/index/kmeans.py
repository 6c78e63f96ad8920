"""Balanced spherical k-means for shard centroid selection.

Counterpart of ``meme_search_engine_tpu/index/kmeans.py`` (the reference's
kmeans.py:72-127): records spill into their top-SPILL_K (= 2) shards
downstream, so balance is measured over both ranks. Emits fp16
``centroids.bin``.

The JAX package is XLA here, so the port is plain torch on ``device``
("cuda" unless the caller asks for the CPU). Three differences of means,
not of result:

- Top-k keeps ``lax.top_k``'s tie order through a stable descending sort.
- A Lloyd step sums each cluster's members as one (N, K) 0/1 membership
  matrix times x in fp32, where the JAX package scatter-adds: CUDA's
  ``index_add_`` sums with float atomics in an order that changes from run
  to run, the product sums in a fixed order.
- The annealing noise comes from a CPU ``torch.Generator`` seeded with
  ``seed`` (``jax.random`` cannot be reproduced), so the card and the CPU
  anneal from the same numbers. The numpy draws are the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.mips import top_k

__all__ = ["balanced_kmeans", "assign_top_k", "save_centroids", "load_centroids", "SPILL_K"]

SPILL_K = 2  # kmeans.py:72


def _normalised(c: torch.Tensor) -> torch.Tensor:
    return c / c.norm(dim=1, keepdim=True).clamp_min(1e-30)


def assign_top_k(vectors: torch.Tensor, centroids: torch.Tensor, spill_k: int = SPILL_K) -> torch.Tensor:
    """(N, D), (K, D) -> (N, spill_k) top-similarity centroid ids (int64)."""
    c = torch.as_tensor(centroids, dtype=torch.float32, device=vectors.device)
    sims = vectors.float() @ _normalised(c).T
    return top_k(sims, spill_k)[1]


def _fitness(vectors: torch.Tensor, centroids: torch.Tensor, k: int, spill_k: int):
    """max |cluster size - ideal| over both assignment ranks, plus the
    worst centroid (kmeans.py:76-95); 0-dim tensors."""
    idx = assign_top_k(vectors, centroids, spill_k)
    ideal = vectors.shape[0] / k
    sizes = torch.stack([torch.bincount(idx[:, r], minlength=k) for r in range(spill_k)]).float()
    dist = (sizes - ideal).abs()
    return dist.max(), dist.max(dim=0).values.argmax()


def _lloyd_step(x: torch.Tensor, centroids: torch.Tensor, k: int):
    """One spherical Lloyd step over top-SPILL_K membership: (unnormalised
    new centroids, combined top-2 counts)."""
    idx = top_k(x @ _normalised(centroids).T, SPILL_K)[1]
    member = torch.zeros((x.shape[0], k), dtype=torch.float32, device=x.device)
    member.scatter_(1, idx, 1.0)  # the two ranks name two different clusters
    sums = member.T @ x
    counts = member.sum(dim=0)
    new_c = sums / counts.clamp_min(1.0)[:, None]
    # empty clusters keep their old position instead of collapsing to 0
    return torch.where(counts[:, None] > 0, new_c, centroids), counts


def balanced_kmeans(
    vectors,
    n_clusters: int,
    *,
    max_iter: int = 200,
    seed: int = 0,
    target_frac: float = 0.1,
    verbose: bool = False,
    lloyd_iters: int = 100,
    device="cuda",
) -> np.ndarray:
    """Data-init spherical Lloyd with split/merge rebalancing, polished by
    the reference's simulated annealing; the JAX package's docstring gives
    the reasons for each step. ``vectors`` is numpy or a tensor; it is
    read as fp32 on ``device``. Returns L2-normalised centroids
    (n_clusters, D) float32 numpy."""
    x = torch.as_tensor(vectors).to(device=device, dtype=torch.float32)
    n, d = x.shape
    gen = torch.Generator().manual_seed(seed)
    nrng = np.random.default_rng(seed)

    init_idx = nrng.choice(n, n_clusters, replace=n < n_clusters)
    centroids = x[torch.as_tensor(init_idx, device=x.device)]
    ideal2 = 2.0 * n / n_clusters  # combined top-2 count target

    # --- balance-aware Lloyd with split/merge -----------------------------
    settle = max(8, lloyd_iters // 5)  # no splits in the last iters
    for it in range(lloyd_iters):
        centroids, counts = _lloyd_step(x, centroids, n_clusters)
        if it < lloyd_iters - settle:
            c_host = counts.cpu().numpy()
            order_over = np.argsort(-c_host)
            order_under = np.argsort(c_host)
            cent_host = None
            for over, under in zip(order_over, order_under):
                if c_host[over] < 1.25 * ideal2 or c_host[under] > 0.6 * ideal2:
                    break
                if cent_host is None:
                    cent_host = centroids.cpu().numpy().copy()
                scale = 0.05 * np.linalg.norm(cent_host[over]) / np.sqrt(d)
                cent_host[under] = cent_host[over] + (
                    scale * nrng.standard_normal(d).astype(np.float32)
                )
                c_host[over] *= 0.5  # donor can't donate again this round
            if cent_host is not None:
                centroids = torch.from_numpy(cent_host).to(x.device)
        if verbose and it % 10 == 0:
            ch = counts.cpu().numpy()
            print(
                f"kmeans lloyd {it}: counts p95/med "
                f"{np.percentile(ch, 95) / max(1.0, float(np.median(ch))):.2f}"
            )

    # --- annealing polish ---------------------------------------------------
    desired = n / n_clusters
    med_norm = float(np.median(centroids.norm(dim=1).cpu().numpy())) / np.sqrt(d)
    temperature = 0.1 * med_norm
    last_fit = float(_fitness(x, centroids, n_clusters, SPILL_K)[0])
    best, best_fit = centroids, last_fit
    stall = 0

    for it in range(max_iter):
        noise = torch.randn(centroids.shape, generator=gen).to(x.device)
        cand = centroids + noise * temperature
        fit, worst = _fitness(x, cand, n_clusters, SPILL_K)
        fit = float(fit)
        if fit < last_fit:
            centroids, last_fit = cand, fit
            temperature *= 0.999
            stall = 0
        else:
            temperature *= 0.9995
            stall += 1
        if stall > 100:
            # reroll the most-imbalanced centroid onto a data point; a copy,
            # since `best` may be this very tensor
            centroids = centroids.clone()
            centroids[int(worst)] = x[int(nrng.integers(n))]
            stall = 0
            temperature = min(10 * 0.1 * med_norm, temperature * 1.1)
            last_fit = fit
        if fit < best_fit:
            best, best_fit = cand, fit
        if verbose and it % 20 == 0:
            print(f"kmeans iter {it}: fitness {last_fit:.1f} T={temperature:.3f}")
        if last_fit < desired * target_frac:
            break

    return _normalised(best).cpu().numpy().astype(np.float32)


def save_centroids(centroids: np.ndarray, path: str):
    """fp16 centroids.bin artifact (kmeans.py:150-153)."""
    np.asarray(centroids, np.float16).tofile(path)


def load_centroids(path: str, n_dims: int) -> np.ndarray:
    return np.fromfile(path, dtype=np.float16).reshape(-1, n_dims).astype(np.float32)
