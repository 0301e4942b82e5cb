"""Pure-NumPy oracle of the reference's exact algorithm.

This module re-states, in plain NumPy, precisely what the reference computes
— k-means++ seeding over the *full* corpus with incrementally updated
weights (``src/kmeans.rs:142-229``), Lloyd's loop with the normalized
max-displacement convergence rule and R <= 100 rounds
(``src/kmeans.rs:104-139``), the residual IVF build pipeline
(``src/db/build.rs:78-129``), and the ADC partition query
(``src/db/build.rs:521-565``). It exists for two reasons:

1. **Quality parity**: the device build's inertia and
   recall must match this oracle within stochastic noise at equal
   ``(P, D, C)`` on the same data — that is the testable meaning of
   "matches reference recall at equal PQ memory" when RNG streams can never
   be bit-identical across implementations.
2. **dtype genericity**: the reference's number-trait layer makes the whole
   stack f32/f64-generic (``src/numbers.rs:6-111``). The device path is
   f32; this oracle is the f64-capable host path — every
   function takes a ``dtype`` and computes end-to-end in it.

It is deliberately slow (CPU, no JAX): correctness reference, not a serving
path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

#: Maximum Lloyd's rounds (``kmeans.rs:114``).
MAX_ROUNDS = 100

#: Convergence epsilon per dtype (``kmeans.rs:19-34``).
EPSILON = {np.float32: 1e-6, np.float64: 1e-12}


def _eps(dtype) -> float:
    return EPSILON[np.dtype(dtype).type]


def weighted_sample(weights: np.ndarray, rng: np.random.Generator) -> int:
    """Samples an index with probability proportional to ``weights``.

    The reference's ``WeightedIndex`` draws a uniform in ``[0, total)`` and
    walks the cumulative sum, skipping zero weights
    (``distribution.rs:99-122``); with float weights that is exactly
    inverse-CDF sampling.
    """
    total = float(weights.sum())
    if total <= 0.0:
        # All remaining weights zero (all vectors identical): the reference
        # panics here (kmeans.rs:199 TODO); we mirror the device path's
        # degenerate-to-first-index behavior.
        return 0
    u = rng.uniform(0.0, total)
    cum = np.cumsum(weights)
    return int(np.searchsorted(cum, u, side="right").clip(0, len(cum) - 1))


def plusplus_init(x: np.ndarray, k: int, rng: np.random.Generator,
                  ) -> np.ndarray:
    """k-means++ over the full corpus (``kmeans.rs:142-229``).

    First centroid uniform; each subsequent centroid sampled with
    probability proportional to the running minimum squared distance, with
    chosen points' weights zeroed (the ``WeightedIndex.update`` calls at
    ``kmeans.rs:209-219``).
    """
    n, m = x.shape
    k_out = np.empty((k, m), x.dtype)
    ci = int(rng.integers(0, n))
    k_out[0] = x[ci]
    if k == 1:
        return k_out
    w = ((x - x[ci]) ** 2).sum(-1)
    w[ci] = 0.0
    for i in range(1, k):
        ci = weighted_sample(w, rng)
        k_out[i] = x[ci]
        d = ((x - x[ci]) ** 2).sum(-1)
        np.minimum(w, d, out=w)
        w[ci] = 0.0
    return k_out


class OracleKMeans(NamedTuple):
    centroids: np.ndarray   # [K, M]
    indices: np.ndarray     # [N] int64
    rounds: int
    gradient: float


def kmeans(x: np.ndarray, k: int, rng: np.random.Generator, *,
           dtype=np.float32, max_rounds: int = MAX_ROUNDS) -> OracleKMeans:
    """k-means++ + Lloyd's with the reference's convergence rule.

    Stops when ``max_k ||c_old - c_new|| / max_k ||c_new|| < epsilon``
    after the centroid update, *before* reassignment (``kmeans.rs:125-137``)
    — converged runs return assignments predating the final update.
    ``N == k`` short-circuits to one vector per cluster
    (``kmeans.rs:158-169``).
    """
    x = np.asarray(x, dtype)
    n, m = x.shape
    if n < k:
        raise ValueError(f"vs has fewer vectors than k: {n} < {k}")
    if n == k:
        return OracleKMeans(x.copy(), np.arange(n), 0, 0.0)
    eps = _eps(dtype)

    centroids = plusplus_init(x, k, rng)
    indices = _assign(x, centroids)
    grad = np.inf
    for r in range(max_rounds):
        new = _update(x, indices, centroids, k)
        grad = _gradient(centroids, new)
        centroids = new
        if grad < eps:
            return OracleKMeans(centroids, indices, r + 1, float(grad))
        indices = _assign(x, centroids)
    return OracleKMeans(centroids, indices, max_rounds, float(grad))


def _assign(x: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Brute-force nearest centroid (``kmeans.rs:279-306``)."""
    # ||x||^2 - 2 x c^T + ||c||^2; exact argmin unaffected by the shared
    # ||x||^2 term.
    d = (centroids ** 2).sum(-1)[None, :] - 2.0 * (x @ centroids.T)
    return np.argmin(d, axis=1)


def _update(x: np.ndarray, indices: np.ndarray, old: np.ndarray,
            k: int) -> np.ndarray:
    """Cluster means; empty clusters keep the previous centroid (the
    documented divergence from the reference's panic, ``kmeans.rs:259``)."""
    sums = np.zeros_like(old)
    np.add.at(sums, indices, x)
    counts = np.bincount(indices, minlength=k).astype(old.dtype)
    empty = counts == 0
    out = sums / np.where(empty, 1, counts)[:, None]
    out[empty] = old[empty]
    return out


def _gradient(old: np.ndarray, new: np.ndarray) -> float:
    """``max_k ||Δc|| / max_k ||c_new||`` (``kmeans.rs:261-275``)."""
    dist = np.linalg.norm(old - new, axis=-1)
    norm = np.linalg.norm(new, axis=-1)
    mx = norm.max()
    return float(dist.max() / mx) if mx > 0 else 0.0


def inertia(x: np.ndarray, centroids: np.ndarray,
            indices: np.ndarray) -> float:
    """Sum of squared distances to assigned centroids (quality metric)."""
    return float(((np.asarray(x, np.float64) -
                   np.asarray(centroids, np.float64)[indices]) ** 2).sum())


class OracleBuild(NamedTuple):
    partition_centroids: np.ndarray   # [P, M]
    partition_indices: np.ndarray     # [N]
    codebooks: np.ndarray             # [D, C, M/D]
    codes: np.ndarray                 # [N, D]


def build(x: np.ndarray, p: int, d: int, c: int,
          rng: np.random.Generator, *, dtype=np.float32) -> OracleBuild:
    """The full IVF-PQ build pipeline (``db/build.rs:78-129``):
    coarse k-means -> residual subtraction (``partitions.rs:115-144``) ->
    per-division PQ k-means over ``divide_vector_set`` column blocks
    (``vector.rs:154-174``)."""
    x = np.asarray(x, dtype)
    n, m = x.shape
    coarse = kmeans(x, p, rng, dtype=dtype)
    residues = x - coarse.centroids[coarse.indices]
    sub = m // d
    codebooks = np.empty((d, c, sub), dtype)
    codes = np.empty((n, d), np.int64)
    for di in range(d):                      # sequential, as the reference
        r = kmeans(residues[:, di * sub:(di + 1) * sub], c, rng, dtype=dtype)
        codebooks[di] = r.centroids
        codes[:, di] = r.indices
    return OracleBuild(coarse.centroids, coarse.indices, codebooks, codes)


def adc_query(v: np.ndarray, b: OracleBuild, k: int, nprobe: int,
              ) -> tuple[np.ndarray, np.ndarray]:
    """ADC k-NN over the oracle build (``db/build.rs:521-565``).

    Returns ``(rows [<=k], sq_distances)`` into the original corpus order,
    best first.
    """
    d, c, sub = b.codebooks.shape
    coarse = ((v[None] - b.partition_centroids) ** 2).sum(-1)
    probed = np.argsort(coarse, kind="stable")[:nprobe]
    rows_all, dist_all = [], []
    for pi in probed:
        members = np.nonzero(b.partition_indices == pi)[0]
        if len(members) == 0:
            continue
        local = (v - b.partition_centroids[pi]).reshape(d, sub)
        table = ((local[:, None, :] - b.codebooks) ** 2).sum(-1)
        dists = table[np.arange(d)[None, :], b.codes[members]].sum(1)
        rows_all.append(members)
        dist_all.append(dists)
    rows = np.concatenate(rows_all)
    dists = np.concatenate(dist_all)
    order = np.argsort(dists, kind="stable")[:k]
    return rows[order], dists[order]
