"""Pruned IVF-PQ query over partition-bucketed codes.

The masked full scan (:mod:`.adc`) touches all ``N`` code rows per query —
optimal when ``nprobe × avg_partition ≈ N``, wasteful when ``nprobe ≪ P``
(SIFT1M: P=1024, nprobe=10 ⇒ ~100× extra reads). This module is the pruned
layout: codes bucketize by partition into a padded ``[P, D, L]`` block array
(the device analogue of the reference's per-partition files,
``database.proto:47-63``), and a query touches only its ``nprobe`` buckets:

1. coarse top-k picks ``probed [B, nprobe]``,
2. ADC tables ONLY for probed partitions: ``[B, nprobe, D, C]`` einsum,
3. bucket lookup: table lookup-sum over the probed buckets
   (:func:`bucket_scan`),
4. mask pad rows, ``lax.top_k`` over ``[B, nprobe·L]``.

Static shapes throughout — ragged partition sizes become one padded length
``L`` (max partition size rounded up to a multiple of 128), so there is no
retracing across queries or nprobe sets (SURVEY.md §7 "hard parts").
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .adc import adc_tables  # noqa: F401  (re-exported pattern)
from .adc import coarse_scores

_PRECISION = jax.lax.Precision.HIGHEST


class Buckets(NamedTuple):
    """Partition-major padded code layout.

    ``codes: [P, D, L] int32`` (0 in pad slots) — or, packed,
    ``[P, ceil(D/4), L] int32`` with four byte-sized codes per word
    (division ``d`` in byte ``d % 4``, little-endian); ``rows: [P, L]
    int32`` original corpus row per slot, ``-1`` in pad slots;
    ``lengths: [P]``. :func:`query_bucketed` detects packing from the
    shape (``codes.shape[1] != D``).

    The member axis ``L`` is minor, so one bucket's codes for one
    division are contiguous and the scan reads them in order. Packing
    cuts the resident code array (and the per-query bucket gather) 4×.
    """
    codes: jax.Array
    rows: jax.Array
    lengths: jax.Array


def bucketize(codes: np.ndarray, pidx: np.ndarray, p: int,
              lane: int = 128, pack: bool | str = False) -> Buckets:
    """Host-side bucketization of ``codes [N, D]`` by partition.

    ``L`` = max partition size rounded up to a multiple of ``lane``.

    ``pack``: ``True`` packs four codes per int32 word (requires every
    code < 256 and D > 1, else raises); ``"auto"`` packs when possible;
    ``False`` (default) keeps one code per int32.
    """
    codes = np.asarray(codes)
    pidx = np.asarray(pidx)
    n, d = codes.shape
    packable = d > 1 and (n == 0 or int(codes.max(initial=0)) < 256)
    if pack == "auto":
        pack = packable
    elif pack and not packable:
        raise ValueError(
            "pack=True needs D > 1 and all codes < 256 "
            f"(D={d}, max code={int(codes.max(initial=0)) if n else 0})")
    counts = np.bincount(pidx, minlength=p)
    l = int(max(counts.max() if n else 1, 1))
    l = -(-l // lane) * lane
    bcodes = np.zeros((p, d, l), np.int32)
    brows = np.full((p, l), -1, np.int32)
    order = np.argsort(pidx, kind="stable")
    starts = np.zeros(p + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    # One bulk scatter instead of a Python loop over P partitions (the
    # loop cost minutes at P=4096/N=10M on a 1-vCPU serving host): the
    # slot of sorted row i is its rank within its partition.
    sorted_p = pidx[order]
    slot = np.arange(n, dtype=np.int64) - starts[sorted_p]
    brows[sorted_p, slot] = order
    bcodes[sorted_p, :, slot] = codes[order]
    if pack:
        dp = -(-d // 4)
        packed = np.zeros((p, dp, l), np.int32)
        for di in range(d):
            w, b = divmod(di, 4)
            packed[:, w] |= bcodes[:, di] << (8 * b)
        bcodes = packed
    return Buckets(jnp.asarray(bcodes), jnp.asarray(brows),
                   jnp.asarray(counts.astype(np.int32)))


def unpack_codes(words: jax.Array, d: int) -> jax.Array:
    """``[..., ceil(D/4), L] int32`` packed words → ``[..., D, L]`` codes."""
    idx = jnp.arange(d) // 4
    shift = 8 * (jnp.arange(d) % 4)
    w = jnp.take(words, idx, axis=-2)
    return (w >> shift[..., :, None]) & 0xFF


def probed_tables(q: jax.Array, centroids: jax.Array, codebooks: jax.Array,
                  probed: jax.Array,
                  rotation: jax.Array | None = None,
                  metric: str = "l2",
                  coarse: jax.Array | None = None) -> jax.Array:
    """ADC distance tables for the probed partitions only.

    ``q [B, M]``, ``probed [B, nprobe]`` → ``[B, nprobe, D, C]`` where,
    for L2,
    ``tables[b, j, d, c] = ‖(q_b - centroid_{probed[b,j]})_d - cb[d,c]‖²``
    (clamped at 0; OPQ rotation applied to the residual when given).
    For ``metric="dot"`` the tables decompose the negated inner product
    with the per-probe ``−⟨q, c⟩/D`` scalar folded in
    (:func:`.adc._dot_tables`), so the lookup kernels run unchanged;
    ``coarse [B, P]`` (the scores the probe selection already computed,
    ``−q·cᵀ``) supplies those scalars as a gather instead of a second
    centroid GEMM. Shared by the single-chip and sharded bucketed paths.
    """
    b = q.shape[0]
    nprobe = probed.shape[1]
    d, c, sub = codebooks.shape
    if metric == "dot":
        from .adc import _dot_tables
        if coarse is not None:
            cent_scores = jnp.take_along_axis(coarse, probed, axis=1)
        else:
            pc = jnp.take(centroids, probed, axis=0)    # [B, nprobe, M]
            cent_scores = -jnp.einsum(
                "bm,bjm->bj", q, pc, precision=_PRECISION,
                preferred_element_type=jnp.float32)     # [B, nprobe]
        return _dot_tables(q, codebooks, cent_scores, rotation)
    pc = jnp.take(centroids, probed, axis=0)            # [B, nprobe, M]
    resid = q[:, None, :] - pc
    if rotation is not None:  # OPQ: codes live in the rotated space
        resid = jnp.matmul(resid, rotation, precision=_PRECISION,
                           preferred_element_type=jnp.float32)
    resid = resid.reshape(b, nprobe, d, sub)
    rr = jnp.sum(resid * resid, axis=-1)                # [B, nprobe, D]
    cc = jnp.sum(codebooks * codebooks, axis=-1)        # [D, C]
    rc = jnp.einsum("bjds,dcs->bjdc", resid, codebooks,
                    precision=_PRECISION,
                    preferred_element_type=jnp.float32)
    return jnp.maximum(rr[..., None] + cc[None, None] - 2.0 * rc, 0.0)


def bucket_scan(codes: jax.Array, ftab: jax.Array, bidx: jax.Array,
                lengths: jax.Array | None = None, *, d: int) -> jax.Array:
    """Lookup-sum of ``ftab`` over the buckets selected by ``bidx``.

    ``codes [P, D|DP, L]`` resident buckets, ``ftab [G, D*C]``, ``bidx
    [G]`` → ``[G, L]``: per slot, the sum over divisions of the table
    value its code selects. ``lengths [G]`` (optional): per-cell fill
    counts — slots beyond them come back ``+inf``.
    """
    g = ftab.shape[0]
    l = codes.shape[2]
    c = ftab.shape[1] // d
    bcodes = jnp.take(codes, bidx, axis=0)              # [G, D|DP, L]
    if codes.shape[1] != d:
        bcodes = unpack_codes(bcodes, d)
    gidx = bcodes + jnp.arange(d, dtype=jnp.int32)[None, :, None] * c
    vals = jnp.take_along_axis(ftab, gidx.reshape(g, d * l), axis=-1)
    vdist = vals.reshape(g, d, l).sum(axis=1)
    if lengths is None:
        return vdist
    slot = jnp.arange(l, dtype=jnp.int32)
    return jnp.where(slot[None, :] < lengths[:, None], vdist, jnp.inf)


@functools.partial(jax.jit, static_argnames=("nprobe", "metric"))
def range_bucketed(
    q: jax.Array,
    centroids: jax.Array,
    codebooks: jax.Array,
    buckets: Buckets,
    rotation: jax.Array | None = None,
    row_mask: jax.Array | None = None,
    *,
    nprobe: int,
    metric: str = "l2",
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Range-search candidates: every reachable vector's ADC key.

    Same probe selection and bucket scan as :func:`query_bucketed`, but
    instead of a top-k it returns ALL probed candidates —
    ``(keys [B, nprobe·L], rows [B, nprobe·L] int32, probed
    [B, nprobe])`` with non-candidates (pad slots, filtered rows) at
    ``+inf`` / row ``-1``. The caller thresholds host-side (range
    results are inherently ragged; the transfer is ``B·nprobe·L``
    floats — callers chunk query batches). ``metric`` as in
    :mod:`..metrics`.
    """
    b, m = q.shape
    d, c, sub = codebooks.shape
    l = buckets.codes.shape[2]

    coarse = coarse_scores(q, centroids, metric)        # [B, P]
    _, probed = jax.lax.top_k(-coarse, nprobe)          # [B, nprobe]
    tables = probed_tables(q, centroids, codebooks, probed, rotation,
                           metric, coarse)

    vdist = bucket_scan(
        buckets.codes, tables.reshape(b * nprobe, d * c),
        probed.reshape(b * nprobe).astype(jnp.int32), d=d,
    ).reshape(b, nprobe, l)

    lens = jnp.take(buckets.lengths, probed, axis=0)    # [B, nprobe]
    keep = (jnp.arange(l, dtype=jnp.int32)[None, None, :]
            < lens[..., None])
    rows_g = jnp.take(buckets.rows, probed, axis=0)     # [B, nprobe, L]
    if row_mask is not None:
        keep &= jnp.take(row_mask, jnp.maximum(rows_g, 0), axis=0)
    vdist = jnp.where(keep, vdist, jnp.inf)
    rows_g = jnp.where(keep, rows_g, -1)
    return (vdist.reshape(b, nprobe * l),
            rows_g.reshape(b, nprobe * l).astype(jnp.int32),
            probed.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("k", "nprobe", "metric"))
def query_bucketed(
    q: jax.Array,
    centroids: jax.Array,
    codebooks: jax.Array,
    buckets: Buckets,
    rotation: jax.Array | None = None,
    row_mask: jax.Array | None = None,
    *,
    k: int,
    nprobe: int,
    metric: str = "l2",
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Batched pruned IVF-PQ k-NN.

    Same contract as :func:`.adc.query_masked_scan`: returns
    ``(sq_distances [B, k], rows [B, k] int32, probed [B, nprobe] int32)``
    with ``+inf`` beyond the number of reachable vectors. ``metric`` as in
    :mod:`..metrics` ("dot" → distances are negated inner products).

    ``row_mask [N] bool`` (optional): corpus rows whose mask is False are
    excluded (attribute filtering, :mod:`..filters`) — one gather + select
    after the ADC scan, before top-k.
    """
    b, m = q.shape
    p = centroids.shape[0]
    d, c, sub = codebooks.shape
    l = buckets.codes.shape[2]

    coarse = coarse_scores(q, centroids, metric)        # [B, P]
    _, probed = jax.lax.top_k(-coarse, nprobe)          # [B, nprobe]
    tables = probed_tables(q, centroids, codebooks, probed, rotation,
                           metric, coarse)

    # Pad slots are masked from bucket lengths (bucketize fills slots
    # [0, count) in order, so slot < length ⟺ the slot holds a row); the
    # row gather is only paid on filtered queries.
    lens = jnp.take(buckets.lengths, probed, axis=0)    # [B, nprobe]
    vdist = bucket_scan(
        buckets.codes, tables.reshape(b * nprobe, d * c),
        probed.reshape(b * nprobe).astype(jnp.int32),
        lens.reshape(b * nprobe).astype(jnp.int32), d=d,
    ).reshape(b, nprobe, l)

    if row_mask is not None:
        brows = jnp.take(buckets.rows, probed, axis=0)  # [B, nprobe, L]
        keep = jnp.take(row_mask, jnp.maximum(brows, 0), axis=0)
        vdist = jnp.where(keep, vdist, jnp.inf)

    # k may exceed the candidate count (reference returns fewer results
    # then); pad the tail with +inf instead of failing top_k.
    kk = min(k, nprobe * l)
    neg, flat_idx = jax.lax.top_k(-vdist.reshape(b, nprobe * l), kk)
    # Winners → corpus rows: a [B, kk] gather instead of the full per-slot
    # row matrix (pad slots map to buckets.rows == -1, as before).
    win_part = jnp.take_along_axis(probed, flat_idx // l, axis=1)
    rows = jnp.take(buckets.rows.reshape(-1),
                    win_part * l + flat_idx % l)        # [B, kk]
    if kk < k:
        neg = jnp.pad(neg, ((0, 0), (0, k - kk)), constant_values=-jnp.inf)
        rows = jnp.pad(rows, ((0, 0), (0, k - kk)))
    return -neg, rows.astype(jnp.int32), probed.astype(jnp.int32)
