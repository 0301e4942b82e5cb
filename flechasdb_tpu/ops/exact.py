"""Exact (flat) k-NN scan.

The reference lists "Flat database" as an open roadmap item
(``README.md:74``); this is its device-native core: a brute-force scan as a
running top-k fold over corpus chunks — one ``[B, chunk]`` distance matmul
per step, so arbitrarily large corpora stream through device memory with a bounded
footprint. Also serves as the ground-truth oracle for recall benchmarks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .distance import sqdist

_PRECISION = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("k", "chunk", "metric"))
def exact_topk(q: jax.Array, x: jax.Array,
               row_mask: jax.Array | None = None, *, k: int,
               chunk: int = 1 << 17,
               metric: str = "l2") -> tuple[jax.Array, jax.Array]:
    """Exact k nearest neighbours of each query.

    ``q: [B, M]``, ``x: [N, M]`` → ``(sq_distances [B, k], rows [B, k]
    int32)``, ascending. Entries beyond ``N`` carry ``+inf``.
    ``row_mask [N] bool`` (optional) excludes rows whose mask is False
    (attribute filtering, :mod:`..filters`). ``metric`` as in
    :mod:`..metrics`: ``"dot"`` ranks by ``−⟨q, x⟩`` (maximum inner
    product); cosine callers pass unit vectors with the default key.
    """
    b, m = q.shape
    n = x.shape[0]
    if n == 0:
        return (jnp.full((b, k), jnp.inf, jnp.float32),
                jnp.zeros((b, k), jnp.int32))
    chunk = min(chunk, n)
    steps = -(-n // chunk)

    def body(i, state):
        best_d, best_i = state
        start = jnp.minimum(i * chunk, n - chunk)
        xi = jax.lax.dynamic_slice_in_dim(x, start, chunk, axis=0)
        if metric == "dot":
            d = -jnp.matmul(q, xi.T, precision=_PRECISION,
                            preferred_element_type=jnp.float32)
        else:
            d = sqdist(q, xi)                               # [B, chunk]
        rows = start + jnp.arange(chunk, dtype=jnp.int32)
        # Overlapping rows in the (shifted) last chunk must not appear
        # twice in the running set: mask rows already covered.
        fresh = rows >= i * chunk
        if row_mask is not None:
            fresh &= jax.lax.dynamic_slice_in_dim(row_mask, start, chunk)
        d = jnp.where(fresh[None, :], d, jnp.inf)
        cat_d = jnp.concatenate([best_d, d], axis=1)
        cat_i = jnp.concatenate(
            [best_i, jnp.broadcast_to(rows[None, :], d.shape)], axis=1)
        neg, sel = jax.lax.top_k(-cat_d, k)
        return -neg, jnp.take_along_axis(cat_i, sel, axis=1)

    best_d = jnp.full((b, k), jnp.inf, jnp.float32)
    best_i = jnp.zeros((b, k), jnp.int32)
    best_d, best_i = jax.lax.fori_loop(0, steps, body, (best_d, best_i))
    return best_d, best_i.astype(jnp.int32)
