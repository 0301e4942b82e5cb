"""Optimized Product Quantization (OPQ) — learned rotation before PQ.

Quality extension beyond the reference: PQ quantizes each subvector
independently, so correlated dimensions across division boundaries waste
codebook capacity. OPQ learns an orthogonal rotation ``R`` minimizing the
quantization error ``||X R − PQ(X R)||²`` by alternating (a) PQ training on
the rotated data and (b) the orthogonal Procrustes update ``R = U Vᵀ`` from
``SVD(Xᵀ X̂)`` (Ge et al., CVPR 2013 — standard technique, re-derived here
for the device: both the reconstruction and the ``[M, M]`` Gram matrix are single
matmuls; only the small SVD runs on host).

Distances are preserved exactly (``R`` orthogonal ⇒ ``||x − q|| =
||xR − qR||``); at query time the residual is rotated before the ADC tables
are built.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import kmeans

_PRECISION = jax.lax.Precision.HIGHEST


class OPQResult(NamedTuple):
    """``rotation: [M, M]`` orthogonal; ``pq``: final PQ fit on the rotated,
    divided data (codes in ``pq.indices [D, N]``)."""
    rotation: jax.Array
    pq: kmeans.KMeansResult


@functools.partial(jax.jit, static_argnames=("d",))
def _reconstruct(pq_centroids, pq_indices, *, d):
    """PQ reconstruction: ``[D, C, m] + [D, N] -> [N, D*m]``."""
    parts = jnp.take_along_axis(
        pq_centroids, pq_indices[:, :, None], axis=1)     # [D, N, m]
    return parts.transpose(1, 0, 2).reshape(pq_indices.shape[1], -1)


@functools.partial(jax.jit, static_argnames=())
def _gram(x, yhat):
    return jnp.matmul(x.T, yhat, precision=_PRECISION,
                      preferred_element_type=jnp.float32)


@functools.partial(jax.jit, static_argnames=("d", "c", "rounds", "impl"))
def _pq_on_rotated(x, r, key, *, d, c, rounds, impl=None):
    n, m = x.shape
    y = jnp.matmul(x, r, precision=_PRECISION,
                   preferred_element_type=jnp.float32)
    divided = y.reshape(n, d, m // d).transpose(1, 0, 2)
    return kmeans.fit(divided, c, key, max_rounds=rounds, impl=impl)


def fit_opq(x: jax.Array, d: int, c: int, key: jax.Array, *,
            iters: int = 8, inner_rounds: int = 20,
            final_rounds: int = kmeans.MAX_ROUNDS,
            impl: str | None = None) -> OPQResult:
    """Alternating OPQ training on ``x: [N, M]`` (typically IVF residuals).

    ``iters`` alternations with ``inner_rounds``-capped Lloyd fits, then a
    full PQ fit at the final rotation. The ``[M, M]`` SVD runs on host
    (microseconds next to the matmuls). ``impl`` as in
    :func:`..kmeans._fused_round` (e.g. ``"_fast"`` numerics).
    """
    n, m = x.shape
    x = jnp.asarray(x, jnp.float32)
    r = jnp.eye(m, dtype=jnp.float32)
    for it in range(iters):
        pq = _pq_on_rotated(x, r, jax.random.fold_in(key, it),
                            d=d, c=c, rounds=inner_rounds, impl=impl)
        yhat = _reconstruct(pq.centroids, pq.indices, d=d)
        g = np.asarray(_gram(x, yhat))
        u, _, vt = np.linalg.svd(g, full_matrices=False)
        r = jnp.asarray((u @ vt).astype(np.float32))
    pq = _pq_on_rotated(x, r, jax.random.fold_in(key, iters),
                        d=d, c=c, rounds=final_rounds, impl=impl)
    return OPQResult(r, pq)


def quantization_error(x: jax.Array, rotation: jax.Array,
                       pq: kmeans.KMeansResult, *, d: int) -> float:
    """Mean squared reconstruction error of ``x`` under (rotation, pq)."""
    y = jnp.matmul(jnp.asarray(x, jnp.float32), rotation,
                   precision=_PRECISION,
                   preferred_element_type=jnp.float32)
    yhat = _reconstruct(pq.centroids, pq.indices, d=d)
    return float(jnp.mean(jnp.sum((y - yhat) ** 2, axis=-1)))
