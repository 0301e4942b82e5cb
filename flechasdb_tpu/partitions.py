"""IVF coarse partitioning with residual encoding.

Reference (``src/partitions.rs:96-144``): k-means over full vectors, then
each vector has its assigned centroid subtracted *in place*, yielding the
``Partitions { codebook, residues }`` pair whose residues feed PQ training.

Here the entire step is one jitted program: clustering via
:mod:`flechasdb_tpu.ops.kmeans` followed by a batched gather-subtract.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .events import EventHandler, _noop
from .ops import kmeans


class Partitions(NamedTuple):
    """Coarse partitioning result (``partitions.rs:17-22``).

    ``centroids: [P, M]``; ``indices: [N] int32`` partition per vector;
    ``residues: [N, M]`` = vector − assigned centroid.
    """
    centroids: jax.Array
    indices: jax.Array
    residues: jax.Array

    def reconstruct(self, i: int | jax.Array) -> jax.Array:
        """Original vector(s): residue + centroid (``partitions.rs:68-93``)."""
        return self.residues[i] + self.centroids[self.indices[i]]


def partition(x: jax.Array, p: int, key: jax.Array,
              events: EventHandler = _noop,
              epsilon: float = kmeans.DEFAULT_EPSILON,
              impl: str | None = None) -> Partitions:
    """Clusters ``x [N, M]`` into ``p`` partitions and computes residues.

    ``impl`` selects the Lloyd-round numerics
    (:func:`.ops.kmeans._assign_precision`; ``"_fast"`` =
    ``Precision.DEFAULT`` assignment matmuls)."""
    if events is _noop:
        res = kmeans.fit(x[None], p, key, epsilon=epsilon, impl=impl)
    else:
        res = kmeans.fit_with_events(x[None], p, key, events,
                                     epsilon=epsilon, impl=impl)
    centroids, indices = res.centroids[0], res.indices[0]
    residues = _residues(x, centroids, indices)
    return Partitions(centroids, indices, residues)


@jax.jit
def _residues(x, centroids, indices):
    return x - jnp.take(centroids, indices, axis=0)
