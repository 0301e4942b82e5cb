"""Sharded k-means: the Lloyd round per device under ``shard_map`` + ``psum``.

Each device runs :func:`..ops.kmeans._fused_round` on its local corpus
shard, and the ``[K, M]`` cluster sums + ``[K]`` counts — kilobytes per
round — cross the mesh as one ``psum``. Seeding, centroid means, and the
convergence rule are O(K·M) and stay replicated, bit-identical to the
single-chip :func:`..ops.kmeans.fit`.

Reference hot path being scaled: ``kmeans.rs:232-306`` (the two O(N·K·M)
phases of one Lloyd round, SURVEY.md §3.1).

Padding convention: shard_map needs the sharded axis evenly divisible, so
corpora are zero-padded. A zero row contributes nothing to the cluster
sums (it adds a zero vector) but would inflate one
cluster's count — every zero row assigns to the first-minimum cluster of
``argmin_k ‖c_k‖²`` — so that count is corrected after the ``psum``.
Assignments in pad slots are garbage and must be sliced off by the caller.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import kmeans
from .mesh import AXIS


def _replicated(mesh: Mesh, x: jax.Array) -> jax.Array:
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, P()))


def _gather_rows(mesh: Mesh, x: jax.Array, rows: jax.Array) -> jax.Array:
    """``x [B, Np, M]`` (row-sharded) → replicated ``[B, len(rows), M]``."""
    return _replicated(mesh, jnp.take(x, rows, axis=1))


def fused_round_sharded(x: jax.Array, centroids: jax.Array, k: int,
                        impl: str | None, mesh: Mesh, n_pad: int,
                        ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """One Lloyd round over the mesh: per-device round + ``psum``.

    ``x: [B, Np, M]`` sharded ``P(None, AXIS, None)`` with ``n_pad``
    trailing zero rows; ``centroids: [B, K, M]`` replicated. Returns
    ``(indices [B, Np] sharded, sums [B, K, M], counts [B, K])`` with the
    pad rows' count contribution removed.
    """

    def local(xl, c):
        idx, sums, counts = kmeans._fused_round(xl, c, k, impl)
        return (idx, jax.lax.psum(sums, AXIS), jax.lax.psum(counts, AXIS))

    idx, sums, counts = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, AXIS, None), P()),
        out_specs=(P(None, AXIS), P(), P()),
        check_vma=False,
    )(x, centroids)
    if n_pad:
        # Zero pad rows all landed on the first-minimum of ‖c_k‖² (their
        # distance column is exactly cc); remove them from that count.
        cc = jnp.sum(centroids * centroids, axis=-1)       # [B, K]
        k0 = jnp.argmin(cc, axis=-1)                       # [B]
        counts = counts - n_pad * jax.nn.one_hot(k0, k, dtype=counts.dtype)
    return idx, sums, counts


def _assign_sharded(x: jax.Array, centroids: jax.Array, k: int,
                    impl: str | None, mesh: Mesh) -> jax.Array:
    """Sharded assignment-only pass (no collective needed)."""
    return jax.shard_map(
        lambda xl, c: kmeans._assign_only(xl, c, k, impl), mesh=mesh,
        in_specs=(P(None, AXIS, None), P()),
        out_specs=P(None, AXIS),
        check_vma=False,
    )(x, centroids)


def fit_sharded(x: jax.Array, k: int, key: jax.Array, *, mesh: Mesh,
                n_valid: int,
                epsilon: float = kmeans.DEFAULT_EPSILON,
                max_rounds: int = kmeans.MAX_ROUNDS,
                impl: str | None = None,
                train_cap: int | None = None) -> kmeans.KMeansResult:
    """Sharded analogue of :func:`..ops.kmeans.fit` — same key stream, same
    convergence rule, same tie-breaking; cluster sums cross the mesh as
    ``psum`` instead of living on one chip.

    ``x: [B, Np, M]`` row-sharded over ``mesh`` with rows ``>= n_valid``
    zero-padded. ``indices`` comes back sharded with garbage in pad slots.
    Seeding draws the SAME subsample rows as the single-chip path (the
    k-means++ chain is serial and tiny, so it runs replicated on the
    gathered sample — identical arithmetic, identical draws).

    ``train_cap`` as in :func:`..ops.kmeans.fit` (same key split, same
    rows): the Lloyd rounds run on a re-sharded ``train_cap``-row
    subsample, then one sharded full-corpus assignment pass.
    """
    b, np_, m = x.shape
    n = n_valid
    n_pad = np_ - n
    kmeans._assign_precision(impl)  # validates impl
    if n < k:
        raise ValueError(f"vs has fewer vectors than k: {n} < {k}")
    if max_rounds < 1:
        raise ValueError(
            f"fit_sharded needs max_rounds >= 1: {max_rounds}")
    if n == k:                    # before the cap check, as fit() orders it
        cents = _gather_rows(mesh, x, jnp.arange(n))
        idx = jnp.broadcast_to(jnp.arange(np_, dtype=jnp.int32), (b, np_))
        return kmeans.KMeansResult(cents, idx, jnp.zeros((b,), jnp.int32),
                                   jnp.zeros((b,), jnp.float32))
    if train_cap is not None and train_cap > 0 and n > train_cap:
        if train_cap < k:
            raise ValueError(
                f"train_cap is smaller than k: {train_cap} < {k}")
        k_rows, k_sub = jax.random.split(key)   # fit's cap key stream
        rows = jax.random.randint(k_rows, (train_cap,), 0, n)
        n_dev = mesh.devices.size
        spad = (-train_cap) % n_dev
        sp = jnp.pad(jnp.take(x, rows, axis=1), ((0, 0), (0, spad), (0, 0)))
        sp = jax.lax.with_sharding_constraint(
            sp, NamedSharding(mesh, P(None, AXIS, None)))
        sub = fit_sharded(sp, k, k_sub, mesh=mesh, n_valid=train_cap,
                          epsilon=epsilon, max_rounds=max_rounds, impl=impl)
        idx = _assign_sharded(x, sub.centroids, k, impl, mesh)
        return kmeans.KMeansResult(sub.centroids, idx, sub.rounds,
                                   sub.gradient)
    # Seeding — mirrors kmeans._subsampled_init exactly (same key splits,
    # same rows) on a replicated gather of the (sub)sample.
    cap = kmeans._seed_cap(k)
    if n <= cap:
        sample = _gather_rows(mesh, x, jnp.arange(n))
        centroids, _ = kmeans.plusplus_init(sample, k, key)
    else:
        k_pick, k_seed = jax.random.split(key)
        rows = jax.random.randint(k_pick, (cap,), 0, n)
        sample = _gather_rows(mesh, x, rows)
        centroids, _ = kmeans.plusplus_init(sample, k, k_seed)
    centroids = _replicated(mesh, centroids)
    indices = jnp.zeros((b, np_), jnp.int32)

    # The convergence/freeze semantics live in ONE place —
    # kmeans.lloyd_loop; only the round kernel (psum-reduced, pad-count
    # corrected), the epilogue assignment, and the replication re-pin
    # differ from the single-chip fit.
    return kmeans.lloyd_loop(
        centroids, indices, x.dtype, epsilon=epsilon, max_rounds=max_rounds,
        round_fn=lambda c: fused_round_sharded(x, c, k, impl, mesh, n_pad),
        assign_fn=lambda c: _assign_sharded(x, c, k, impl, mesh),
        post_update=lambda c: _replicated(mesh, c))
