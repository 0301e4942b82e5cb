"""Fused IVF-PQ query kernels (asymmetric distance computation).

Reference query path (``db/build.rs:307-382, 521-565`` in-memory;
``db/stored.rs:394-442, 549-598`` stored): localize the query against every
partition centroid, pick the ``nprobe`` nearest partitions, build a ``D×C``
ADC distance table per selected partition, then scan members accumulating
``Σ_d table[d, code[d]]`` and keep the ``k`` best.

Device-first redesign — one fused program per query batch:

1. Coarse distances to all ``P`` centroids: one ``[B, P]`` matmul.
2. ``lax.top_k`` picks ``nprobe`` partitions per query.
3. ADC tables for *all* partitions at once: ``[B, P, D, C]`` via a single
   einsum (tables are tiny — for P=100, D=12, C=256 that's 1.2 MB/query —
   and building all of them removes every gather from the critical path).
4. A *masked full scan*: every vector's approximate distance is computed
   with its own partition's table (a flat ``[N, D]`` gather), and vectors in
   unselected partitions are masked to +inf. Results are bit-identical to an
   nprobe-pruned scan, but the scan itself is a dense, statically-shaped
   gather-sum — no ragged partition handling, no retracing per nprobe set.
5. ``lax.top_k`` for the final k-best merge (replaces ``nbest.rs``).

The masked scan reads ``N×D`` table entries; at u32 codes and f32 tables the
whole thing is memory-bandwidth bound and fast for corpus sizes a single device
holds. A gather-pruned variant (only selected partitions' codes touched)
pays off when ``nprobe × avg_len ≪ N``; see ``pruned`` mode below.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .distance import sqdist

_PRECISION = jax.lax.Precision.HIGHEST


def coarse_scores(q: jax.Array, centroids: jax.Array,
                  metric: str = "l2") -> jax.Array:
    """Coarse partition ranking keys (lower = better), ``[B, P]``.

    L2/cosine: squared distances (cosine callers pass unit vectors, so
    the same key ranks by similarity); dot: ``−q·cᵀ`` — the partitions
    whose centroids have the largest inner product with the query are
    probed (see :mod:`..metrics`).
    """
    if metric == "dot":
        return -jnp.matmul(q, centroids.T, precision=_PRECISION,
                           preferred_element_type=jnp.float32)
    return sqdist(q, centroids)


def _dot_tables(q: jax.Array, codebooks: jax.Array,
                cent_scores: jax.Array,
                rotation: jax.Array | None) -> jax.Array:
    """MIPS ADC tables with the per-partition scalar folded in.

    ``q [B, M]``, ``cent_scores [B, J] = −⟨q, c_j⟩`` (J = P or nprobe) →
    ``[B, J, D, C]`` where summing ``t[b, j, d, code_d]`` over d yields
    exactly ``−⟨q, x̂⟩`` for a vector encoded in partition j:
    ``t[b, j, d, c] = −⟨q'_d, cb[d, c]⟩ + cent_scores[b, j]/D`` with
    ``q' = q @ R`` under OPQ (codes live in the rotated space and R is
    orthogonal, so ``⟨q, r⟩ = ⟨qR, rR⟩``).
    """
    b, m = q.shape
    d, c, sub = codebooks.shape
    qr = q if rotation is None else jnp.matmul(
        q, rotation, precision=_PRECISION,
        preferred_element_type=jnp.float32)
    qc = jnp.einsum("bds,dcs->bdc", qr.reshape(b, d, sub), codebooks,
                    precision=_PRECISION,
                    preferred_element_type=jnp.float32)   # [B, D, C]
    return cent_scores[..., None, None] / d - qc[:, None, :, :]


def adc_tables(q: jax.Array, centroids: jax.Array,
               codebooks: jax.Array,
               rotation: jax.Array | None = None,
               ) -> tuple[jax.Array, jax.Array]:
    """Coarse distances and L2 ADC tables for every partition.

    ``q: [B, M]``, ``centroids: [P, M]``, ``codebooks: [D, C, m]`` →
    ``(coarse [B, P], tables [B, P, D, C])`` where
    ``tables[b, p, d, c] = ||(q_b - cent_p)_d - codebook[d, c]||²``
    (the reference builds these per selected partition at
    ``db/stored.rs:556-573``). With an OPQ ``rotation [M, M]`` the residual
    is rotated before division (codes live in the rotated space; coarse
    distances are rotation-invariant). L2-only by construction: the dot
    metric never needs P-sized tables (its key decomposes —
    :func:`masked_scan_keys` for the flat layout, :func:`_dot_tables`
    via :func:`..bucketed.probed_tables` for the pruned one).
    """
    b, m = q.shape
    p = centroids.shape[0]
    d, c, sub = codebooks.shape

    coarse = sqdist(q, centroids)                      # [B, P]

    resid = q[:, None, :] - centroids[None, :, :]      # [B, P, M]
    if rotation is not None:
        resid = jnp.matmul(resid, rotation, precision=_PRECISION,
                           preferred_element_type=jnp.float32)
    resid = resid.reshape(b, p, d, sub)
    rr = jnp.sum(resid * resid, axis=-1)               # [B, P, D]
    cc = jnp.sum(codebooks * codebooks, axis=-1)       # [D, C]
    rc = jnp.einsum(
        "bpds,dcs->bpdc", resid, codebooks,
        precision=_PRECISION, preferred_element_type=jnp.float32)
    tables = jnp.maximum(
        rr[..., None] + cc[None, None, :, :] - 2.0 * rc, 0.0)
    return coarse, tables


def masked_scan_keys(q, centroids, codebooks, codes, pidx, rotation,
                     metric, safe_pidx=None):
    """Every row's ADC ranking key over the flat layout: ``(vdist [B, N],
    coarse [B, P])`` — the scan core shared by the top-k and range entry
    points (and the sharded local scan).

    L2: per-partition residual tables ``[B, P, D, C]`` + a flat gather.
    Dot: the key decomposes as ``coarse[pidx] − Σ_d ⟨q'_d, cb[d, code]⟩``,
    so only a ``[B, D, C]`` query·codebook table exists — no P-sized
    table is ever built and per-query transients shrink from
    ``4·(P·D·C + P·M)`` to ``4·D·C`` bytes (the serving layer's batch
    chunking accounts for this, ``serving._masked_limit``).

    ``safe_pidx`` (optional) is a clamped copy for gathers when ``pidx``
    carries ``-1`` padding (the sharded local scan); masking those rows
    stays the CALLER's job.
    """
    b, m = q.shape
    p = centroids.shape[0]
    d, c, _ = codebooks.shape
    n = codes.shape[0]
    gp = pidx if safe_pidx is None else safe_pidx

    if metric == "dot":
        coarse = coarse_scores(q, centroids, metric)    # [B, P] = −q·cᵀ
        qr = q if rotation is None else jnp.matmul(
            q, rotation, precision=_PRECISION,
            preferred_element_type=jnp.float32)
        qc = jnp.einsum("bds,dcs->bdc", qr.reshape(b, d, -1), codebooks,
                        precision=_PRECISION,
                        preferred_element_type=jnp.float32)  # [B, D, C]
        gidx = jnp.arange(d, dtype=jnp.int32)[None, :] * c + codes
        vals = jnp.take(qc.reshape(b, d * c), gidx.reshape(-1), axis=1)
        vdist = (jnp.take(coarse, gp, axis=1)
                 - vals.reshape(b, n, d).sum(axis=-1))  # [B, N]
        return vdist, coarse

    coarse, tables = adc_tables(q, centroids, codebooks, rotation)
    flat = tables.reshape(b, p * d * c)
    gidx = (gp[:, None] * (d * c)
            + jnp.arange(d, dtype=jnp.int32)[None, :] * c
            + codes)                                    # [N, D]
    vdist = jnp.take(flat, gidx.reshape(-1), axis=1)    # [B, N*D]
    return vdist.reshape(b, n, d).sum(axis=-1), coarse


@functools.partial(jax.jit, static_argnames=("k", "nprobe", "metric"))
def query_masked_scan(
    q: jax.Array,
    centroids: jax.Array,
    codebooks: jax.Array,
    codes: jax.Array,
    pidx: jax.Array,
    rotation: jax.Array | None = None,
    row_mask: jax.Array | None = None,
    *,
    k: int,
    nprobe: int,
    metric: str = "l2",
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Batched IVF-PQ k-NN over an in-memory corpus.

    ``q: [B, M]``; ``codes: [N, D] int32`` PQ codes per vector; ``pidx: [N]
    int32`` owning partition per vector; ``row_mask: [N] bool`` (optional)
    excludes rows whose mask is False (attribute filtering,
    :mod:`..filters`). Returns ``(sq_distances [B, k], vector_rows [B, k]
    int32, probed [B, nprobe] int32)``. Entries beyond the number of
    reachable vectors carry ``+inf`` distance. ``metric`` as in
    :mod:`..metrics` (for ``"dot"`` the distances are negated inner
    products; cosine callers pass pre-normalized data and use "l2" keys).
    """
    b, m = q.shape
    p = centroids.shape[0]
    n = codes.shape[0]

    vdist, coarse = masked_scan_keys(q, centroids, codebooks, codes, pidx,
                                     rotation, metric)
    _, probed = jax.lax.top_k(-coarse, nprobe)          # [B, nprobe]

    selected = jax.vmap(
        lambda pr: jnp.zeros((p,), bool).at[pr].set(True))(probed)
    keep = selected[:, pidx]
    if row_mask is not None:
        keep &= row_mask[None, :]
    vdist = jnp.where(keep, vdist, jnp.inf)

    # k may exceed the corpus (reference returns fewer results then,
    # build.rs:334-337); pad the tail with +inf instead of failing top_k.
    kk = min(k, n)
    neg, rows = jax.lax.top_k(-vdist, kk)
    if kk < k:
        neg = jnp.pad(neg, ((0, 0), (0, k - kk)), constant_values=-jnp.inf)
        rows = jnp.pad(rows, ((0, 0), (0, k - kk)))
    return -neg, rows.astype(jnp.int32), probed.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("nprobe", "metric"))
def range_masked_scan(
    q: jax.Array,
    centroids: jax.Array,
    codebooks: jax.Array,
    codes: jax.Array,
    pidx: jax.Array,
    rotation: jax.Array | None = None,
    row_mask: jax.Array | None = None,
    *,
    nprobe: int,
    metric: str = "l2",
) -> tuple[jax.Array, jax.Array]:
    """Range-search candidates on the flat layout: ``(keys [B, N],
    probed [B, nprobe])`` with non-candidates at ``+inf``.

    The masked-scan analogue of :func:`..ops.bucketed.range_bucketed`
    (rows are implicit: column ``i`` IS corpus row ``i``); the caller
    thresholds host-side.
    """
    b, m = q.shape
    p = centroids.shape[0]

    vdist, coarse = masked_scan_keys(q, centroids, codebooks, codes, pidx,
                                     rotation, metric)
    _, probed = jax.lax.top_k(-coarse, nprobe)

    selected = jax.vmap(
        lambda pr: jnp.zeros((p,), bool).at[pr].set(True))(probed)
    keep = selected[:, pidx]
    if row_mask is not None:
        keep &= row_mask[None, :]
    return jnp.where(keep, vdist, jnp.inf), probed.astype(jnp.int32)
