"""Pairwise squared-distance kernels.

The reference computes every distance scalar-by-scalar: ``subtract`` into a
buffer then ``dot`` (e.g. k-means reassignment at ``kmeans.rs:279-306``, ADC
tables at ``db/stored.rs:556-573``). On the device all of those brute-force
scans collapse into one algebraic identity that runs as a matmul::

    ||a - b||^2 = ||a||^2 + ||b||^2 - 2 a.b

Matmuls are issued with ``preferred_element_type=float32`` and HIGHEST
precision so f32 inputs are not silently rounded to TF32 (what DEFAULT and
HIGH allow on GPUs) — distance comparisons drive top-k selection, so we keep
full f32 accuracy.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Distance comparisons feed argmin / top-k; keep matmuls in true f32.
_PRECISION = jax.lax.Precision.HIGHEST


def sqdist(x: jax.Array, c: jax.Array,
           precision: jax.lax.Precision = _PRECISION) -> jax.Array:
    """All-pairs squared Euclidean distances.

    ``x: [..., N, M]``, ``c: [..., K, M]`` → ``[..., N, K]``. Leading batch
    dims broadcast (used with a division axis for PQ). Results are clamped at
    zero: the expanded form can go slightly negative where the reference's
    subtract-then-dot form (``kmeans.rs:294-299``) cannot.

    ``precision`` controls the cross-term matmul: query paths keep the
    HIGHEST (6-pass f32) default since distances drive top-k ranking;
    k-means training passes HIGH (3-pass) — assignment is tolerant and the
    matmuls are the training bottleneck.
    """
    xx = jnp.sum(x * x, axis=-1)[..., :, None]
    cc = jnp.sum(c * c, axis=-1)[..., None, :]
    xc = jnp.matmul(
        x, jnp.swapaxes(c, -1, -2),
        precision=precision,
        preferred_element_type=jnp.float32,
    )
    return jnp.maximum(xx + cc - 2.0 * xc, 0.0)


def sqdist_one(x: jax.Array, v: jax.Array,
               precision: jax.lax.Precision = _PRECISION) -> jax.Array:
    """Squared distances from every row of ``x`` to a single vector ``v``.

    ``x: [..., N, M]``, ``v: [..., M]`` → ``[..., N]``. Used by k-means++
    seeding where one new centroid updates all weights
    (``kmeans.rs:209-219``).
    """
    return sqdist(x, v[..., None, :], precision=precision)[..., 0]


@functools.partial(jax.jit, static_argnames=("k", "chunk", "precision"))
def assign_chunked(x: jax.Array, c: jax.Array, *, k: int,
                   chunk: int = 16384,
                   precision: jax.lax.Precision = _PRECISION,
                   ) -> tuple[jax.Array, jax.Array]:
    """Nearest-centroid assignment, streamed over row chunks.

    ``x: [B, N, M]``, ``c: [B, K, M]`` → ``(indices [B, N] int32,
    min_sqdist [B, N])``. Chunks are taken with ``dynamic_slice`` inside a
    ``fori_loop`` — no padded/transposed copy of ``x`` is ever materialized
    (at GIST1M scale such copies are ~4 GB each).
    The transient ``[B, chunk, K]`` distance tile bounds device memory; this
    replaces the reference's per-vector reassignment loop
    (``kmeans.rs:279-306``) with tiled matmuls.
    """
    b, n, m = x.shape
    chunk = min(chunk, n)
    steps = -(-n // chunk)

    def body(i, state):
        idx, dmin = state
        # Last chunk shifts back to stay in bounds; overlapping rows are
        # recomputed with identical values, so the overwrite is harmless.
        start = jnp.minimum(i * chunk, n - chunk)
        xi = jax.lax.dynamic_slice_in_dim(x, start, chunk, axis=1)
        d = sqdist(xi, c, precision=precision)
        idx = jax.lax.dynamic_update_slice_in_dim(
            idx, jnp.argmin(d, axis=-1).astype(jnp.int32), start, axis=1)
        dmin = jax.lax.dynamic_update_slice_in_dim(
            dmin, jnp.min(d, axis=-1), start, axis=1)
        return idx, dmin

    idx0 = jnp.zeros((b, n), jnp.int32)
    dmin0 = jnp.zeros((b, n), x.dtype)
    return jax.lax.fori_loop(0, steps, body, (idx0, dmin0))
