"""SPMD sharded PRUNED (bucketed) IVF-PQ query.

The masked sharded query (:mod:`.query`) scans all ``N / n_dev`` local
rows per device regardless of ``nprobe`` — it forfeits the pruning of
the single-device bucketed layout. This module shards
the bucketed layout instead: the :class:`..ops.bucketed.Buckets` arrays
split on the PARTITION axis (``[P/n_dev, D|DP, L]`` per device) — the
device analogue of the reference's per-partition content-addressed files
(``db/stored.rs:262-293``; SURVEY.md §2 "storage sharding") — and a query
touches only its probed buckets:

1. every device computes the coarse top-``nprobe`` redundantly from the
   replicated centroids (identical results, no communication),
2. each device scans the probed buckets IT OWNS; probe slots owned by
   other devices are clamped to local bucket 0 and masked to ``+inf``
   through a fill length of 0,
3. local ``top_k(k)`` in GLOBAL corpus rows (bucket slots hold original
   row ids),
4. ``all_gather`` of ``k`` candidates per device + final
   ``top_k`` — the same k-best merge as the masked path
   (``db/stored.rs:378-387`` restated on a mesh).

Expected per-device scan work is ``nprobe/n_dev`` buckets; the static
worst case (every probe on one device) equals the single-chip scan.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.bucketed import Buckets, bucket_scan, probed_tables
from .mesh import AXIS, merge_topk, put_global


def shard_buckets(mesh: Mesh, buckets: Buckets) -> Buckets:
    """Places a bucketed layout partition-sharded across ``mesh``.

    ``P`` pads to a mesh multiple with empty partitions (length 0, rows
    ``-1``) so every device holds an equal ``[P/n_dev, ·, L]`` block.
    """
    n_dev = mesh.devices.size
    codes = np.asarray(buckets.codes)
    rows = np.asarray(buckets.rows)
    lens = np.asarray(buckets.lengths)
    pad = (-codes.shape[0]) % n_dev
    if pad:
        codes = np.pad(codes, ((0, pad), (0, 0), (0, 0)))
        rows = np.pad(rows, ((0, pad), (0, 0)), constant_values=-1)
        lens = np.pad(lens, ((0, pad),))
    return Buckets(
        put_global(codes, NamedSharding(mesh, P(AXIS, None, None))),
        put_global(rows, NamedSharding(mesh, P(AXIS, None))),
        put_global(lens, NamedSharding(mesh, P(AXIS))),
    )


def _local_bucket_scan(q, centroids, codebooks, bcodes, brows, lens,
                       rotation, row_mask, *, k, nprobe, metric):
    """Per-device body: scan owned probed buckets, local top-k, merge."""
    from ..ops.adc import coarse_scores

    b = q.shape[0]
    d, c, _ = codebooks.shape
    ploc, _, l = bcodes.shape
    p0 = jax.lax.axis_index(AXIS) * ploc

    coarse = coarse_scores(q, centroids, metric)        # [B, P] replicated
    _, probed = jax.lax.top_k(-coarse, nprobe)          # [B, nprobe] global
    tables = probed_tables(q, centroids, codebooks, probed, rotation,
                           metric, coarse)

    lidx = probed - p0
    owned = (lidx >= 0) & (lidx < ploc)
    slot = jnp.where(owned, lidx, 0).astype(jnp.int32)  # local bucket id

    # Unowned probe slots join the scan's pad-slot mask as length 0.
    lens_g = jnp.where(owned, jnp.take(lens, slot, axis=0), 0)
    vdist = bucket_scan(
        bcodes, tables.reshape(b * nprobe, d * c),
        slot.reshape(b * nprobe),
        lens_g.reshape(b * nprobe).astype(jnp.int32), d=d,
    ).reshape(b, nprobe, l)

    if row_mask is not None:  # replicated [N] over GLOBAL corpus rows
        rows_g = jnp.take(brows, slot, axis=0)          # [B, nprobe, L]
        keep = jnp.take(row_mask, jnp.maximum(rows_g, 0), axis=0)
        vdist = jnp.where(keep, vdist, jnp.inf)

    kk = min(k, nprobe * l)
    neg, flat = jax.lax.top_k(-vdist.reshape(b, nprobe * l), kk)
    win_slot = jnp.take_along_axis(slot, flat // l, axis=1)
    rows = jnp.take(brows.reshape(-1), win_slot * l + flat % l)
    if kk < k:
        neg = jnp.pad(neg, ((0, 0), (0, k - kk)), constant_values=-jnp.inf)
        rows = jnp.pad(rows, ((0, 0), (0, k - kk)))

    # k-best merge: k candidates per device cross, not the bucket scan.
    mdist, mrows = merge_topk(neg, rows, k)
    return mdist, mrows, probed.astype(jnp.int32)


def _local_range_scan(q, centroids, codebooks, bcodes, brows, lens,
                      rotation, row_mask, *, nprobe, metric):
    """Per-device body for the sharded range scan.

    Same owned-bucket scan as :func:`_local_bucket_scan`, but instead of a
    local top-k + k-best merge it combines the FULL candidate arrays: each
    ``(query, probe)`` slot is owned by exactly one device (probes landing
    on another device's partitions are ``+inf``-masked locally), so the
    global keys are an elementwise ``pmin`` and the global rows a ``psum``
    of the single owner's contribution. The collective moves
    ``B·nprobe·L`` floats — inherent to range search, whose result IS the
    candidate set (the host thresholds it), not a k-best.
    """
    from ..ops.adc import coarse_scores

    b = q.shape[0]
    d, c, _ = codebooks.shape
    ploc, _, l = bcodes.shape
    p0 = jax.lax.axis_index(AXIS) * ploc

    coarse = coarse_scores(q, centroids, metric)        # [B, P] replicated
    _, probed = jax.lax.top_k(-coarse, nprobe)          # [B, nprobe] global
    tables = probed_tables(q, centroids, codebooks, probed, rotation,
                           metric, coarse)

    lidx = probed - p0
    owned = (lidx >= 0) & (lidx < ploc)
    slot = jnp.where(owned, lidx, 0).astype(jnp.int32)

    # Unowned slots as length-0 mask, as in _local_bucket_scan.
    lens_g = jnp.where(owned, jnp.take(lens, slot, axis=0), 0)
    vdist = bucket_scan(
        bcodes, tables.reshape(b * nprobe, d * c),
        slot.reshape(b * nprobe),
        lens_g.reshape(b * nprobe).astype(jnp.int32), d=d,
    ).reshape(b, nprobe, l)

    rows_g = jnp.take(brows, slot, axis=0)              # [B, nprobe, L]
    if row_mask is not None:  # replicated [N] over GLOBAL corpus rows
        vdist = jnp.where(
            jnp.take(row_mask, jnp.maximum(rows_g, 0), axis=0),
            vdist, jnp.inf)
    # kept ⟺ finite: ADC sums of finite tables are finite, and every
    # masked slot (pad, unowned, filtered) is exactly +inf.
    keep = jnp.isfinite(vdist)

    keys = jax.lax.pmin(vdist, AXIS)
    rows = jax.lax.psum(
        jnp.where(keep, rows_g + 1, 0).astype(jnp.int32), AXIS) - 1
    return (keys.reshape(b, nprobe * l),
            rows.reshape(b, nprobe * l),
            probed.astype(jnp.int32))


@functools.partial(jax.jit,
                   static_argnames=("mesh", "nprobe", "metric"))
def range_bucketed_sharded(
    q: jax.Array,
    centroids: jax.Array,
    codebooks: jax.Array,
    buckets: Buckets,
    rotation: jax.Array | None = None,
    row_mask: jax.Array | None = None,
    *,
    mesh: Mesh,
    nprobe: int,
    metric: str = "l2",
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Sharded range-search candidates — the mesh analogue of
    :func:`..ops.bucketed.range_bucketed`, same
    ``(keys [B, nprobe·L], rows [B, nprobe·L], probed)`` contract
    (non-candidates ``+inf`` / row ``-1``), outputs replicated.
    """
    has_rot, has_mask = rotation is not None, row_mask is not None
    extras, especs = [], []
    if has_rot:
        extras.append(rotation)
        especs.append(P())
    if has_mask:
        extras.append(row_mask)
        especs.append(P())

    def local(q, cents, cbs, bc, br, ln, *ex):
        rot = ex[0] if has_rot else None
        rm = ex[-1] if has_mask else None
        return _local_range_scan(q, cents, cbs, bc, br, ln, rot, rm,
                                 nprobe=nprobe, metric=metric)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(AXIS, None, None), P(AXIS, None),
                  P(AXIS), *especs),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return fn(q, centroids, codebooks, buckets.codes, buckets.rows,
              buckets.lengths, *extras)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "k", "nprobe", "metric"))
def query_bucketed_sharded(
    q: jax.Array,
    centroids: jax.Array,
    codebooks: jax.Array,
    buckets: Buckets,
    rotation: jax.Array | None = None,
    row_mask: jax.Array | None = None,
    *,
    mesh: Mesh,
    k: int,
    nprobe: int,
    metric: str = "l2",
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Batched pruned k-NN with buckets partition-sharded over ``mesh``.

    Same contract as :func:`..ops.bucketed.query_bucketed` (``row_mask``
    is over global corpus rows, replicated). ``buckets`` must come from
    :func:`shard_buckets`.
    """
    has_rot, has_mask = rotation is not None, row_mask is not None
    extras, especs = [], []
    if has_rot:
        extras.append(rotation)
        especs.append(P())
    if has_mask:
        extras.append(row_mask)
        especs.append(P())

    def local(q, cents, cbs, bc, br, ln, *ex):
        rot = ex[0] if has_rot else None
        rm = ex[-1] if has_mask else None
        return _local_bucket_scan(q, cents, cbs, bc, br, ln, rot, rm,
                                  k=k, nprobe=nprobe, metric=metric)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(AXIS, None, None), P(AXIS, None),
                  P(AXIS), *especs),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return fn(q, centroids, codebooks, buckets.codes, buckets.rows,
              buckets.lengths, *extras)
