"""SPMD sharded IVF-PQ query.

Single-chip query is one fused program (:mod:`..ops.adc`). Across a mesh the
corpus rows (PQ codes + owning-partition indices) shard over the ``"shard"``
axis and the program becomes, per device:

1. coarse nprobe selection + ADC tables — computed redundantly from the
   replicated centroids/codebooks (tiny: ``[B, P, D, C]``),
2. masked gather-sum scan over the **local** rows,
3. local ``lax.top_k(k)``,
4. ``all_gather`` of the ``k`` per-device candidates, then a final
   ``top_k`` on ``[B, n_dev * k]``.

Only ``n_dev × k`` (distance, row) pairs cross the interconnect — the sharded
analogue of the reference's per-partition k-best merge (``db/stored.rs:378-
387``), which flattens per-partition candidate lists before the global
``n_best_by_key``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.adc import masked_scan_keys
from .mesh import AXIS, merge_topk


def _local_scan(q, centroids, codebooks, codes, pidx, rotation, row_mask,
                *, k, nprobe, metric):
    """Per-device body: scan local rows, return local top-k in global rows."""
    b = q.shape[0]
    p = centroids.shape[0]
    nloc = codes.shape[0]

    # Padding rows carry pidx == -1; clamp for the gathers, mask below.
    safe_pidx = jnp.maximum(pidx, 0)
    vdist, coarse = masked_scan_keys(q, centroids, codebooks, codes, pidx,
                                     rotation, metric, safe_pidx=safe_pidx)
    _, probed = jax.lax.top_k(-coarse, nprobe)            # [B, nprobe]

    selected = jax.vmap(
        lambda pr: jnp.zeros((p,), bool).at[pr].set(True))(probed)
    keep = selected[:, safe_pidx] & (pidx >= 0)[None, :]
    if row_mask is not None:
        keep &= row_mask[None, :]
    vdist = jnp.where(keep, vdist, jnp.inf)

    kk = min(k, nloc)
    neg, rows = jax.lax.top_k(-vdist, kk)
    if kk < k:
        neg = jnp.pad(neg, ((0, 0), (0, k - kk)),
                      constant_values=-jnp.inf)
        rows = jnp.pad(rows, ((0, 0), (0, k - kk)))
    base = jax.lax.axis_index(AXIS) * nloc
    rows = rows + base

    # k-best merge: k candidates per device cross, not the full scan.
    mdist, mrows = merge_topk(neg, rows, k)
    return mdist, mrows, probed.astype(jnp.int32)


def _local_range(q, centroids, codebooks, codes, pidx, rotation, row_mask,
                 *, nprobe, metric):
    """Per-device body for the sharded masked range scan: local keys with
    non-candidates at ``+inf``, then ``all_gather`` back to the global
    ``[B, N]`` column order (shard ``i`` holds rows ``[i·nloc, (i+1)·nloc)``
    — the gather concatenates in axis order, so column ``j`` IS global
    corpus row ``j``, matching :func:`..ops.adc.range_masked_scan`)."""
    p = centroids.shape[0]

    safe_pidx = jnp.maximum(pidx, 0)
    vdist, coarse = masked_scan_keys(q, centroids, codebooks, codes, pidx,
                                     rotation, metric, safe_pidx=safe_pidx)
    _, probed = jax.lax.top_k(-coarse, nprobe)            # [B, nprobe]

    selected = jax.vmap(
        lambda pr: jnp.zeros((p,), bool).at[pr].set(True))(probed)
    keep = selected[:, safe_pidx] & (pidx >= 0)[None, :]
    if row_mask is not None:
        keep &= row_mask[None, :]
    local_keys = jnp.where(keep, vdist, jnp.inf)          # [B, nloc]
    keys = jax.lax.all_gather(local_keys, AXIS, axis=1, tiled=True)
    return keys, probed.astype(jnp.int32)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "nprobe", "metric"))
def range_sharded(
    q: jax.Array,
    centroids: jax.Array,
    codebooks: jax.Array,
    codes: jax.Array,
    pidx: jax.Array,
    rotation: jax.Array | None = None,
    row_mask: jax.Array | None = None,
    *,
    mesh: Mesh,
    nprobe: int,
    metric: str = "l2",
) -> tuple[jax.Array, jax.Array]:
    """Sharded range-search candidates on the flat (masked) layout — the
    mesh analogue of :func:`..ops.adc.range_masked_scan`, same
    ``(keys [B, N_pad], probed [B, nprobe])`` contract (column ``i`` IS
    corpus row ``i``; non-candidates ``+inf``), outputs replicated. Unlike
    the k-NN merge, the full key array crosses devices — inherent to range
    search, whose result is the thresholded candidate set itself.
    """
    has_rot, has_mask = rotation is not None, row_mask is not None
    extras, especs = [], []
    if has_rot:
        extras.append(rotation)
        especs.append(P())
    if has_mask:
        extras.append(row_mask)
        especs.append(P(AXIS))

    def local(q, c, cb, co, pi, *ex):
        rot = ex[0] if has_rot else None
        rm = ex[-1] if has_mask else None
        return _local_range(q, c, cb, co, pi, rot, rm, nprobe=nprobe,
                            metric=metric)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(AXIS, None), P(AXIS), *especs),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(q, centroids, codebooks, codes, pidx, *extras)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "k", "nprobe", "metric"))
def query_sharded(
    q: jax.Array,
    centroids: jax.Array,
    codebooks: jax.Array,
    codes: jax.Array,
    pidx: jax.Array,
    rotation: jax.Array | None = None,
    row_mask: jax.Array | None = None,
    *,
    mesh: Mesh,
    k: int,
    nprobe: int,
    metric: str = "l2",
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Batched k-NN with the corpus sharded across ``mesh``.

    ``codes [N, D]`` / ``pidx [N]`` must be sharded row-wise (see
    :func:`..parallel.mesh.shard_corpus`); ``q``, ``centroids`` and
    ``codebooks`` are replicated; ``row_mask [N] bool`` (optional,
    attribute filtering) must be sharded like ``pidx`` with ``False`` pad
    (:func:`..parallel.mesh.shard_mask`). Returns the same ``(sq_distances
    [B, k], rows [B, k], probed [B, nprobe])`` triple as the single-chip
    kernel, with ``rows`` indexing the (padded) global corpus.
    """
    has_rot, has_mask = rotation is not None, row_mask is not None
    extras, especs = [], []
    if has_rot:
        extras.append(rotation)
        especs.append(P())
    if has_mask:
        extras.append(row_mask)
        especs.append(P(AXIS))

    def local(q, c, cb, co, pi, *ex):
        rot = ex[0] if has_rot else None
        rm = ex[-1] if has_mask else None
        return _local_scan(q, c, cb, co, pi, rot, rm, k=k, nprobe=nprobe,
                           metric=metric)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(AXIS, None), P(AXIS), *especs),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return fn(q, centroids, codebooks, codes, pidx, *extras)
