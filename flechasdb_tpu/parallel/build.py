"""Sharded database build — the distributed "training step".

The reference's 906-second hot path is two k-means phases over the corpus
(``db/build.rs:78-129``; SURVEY.md §3.1). On a mesh, the corpus axis ``N``
shards across devices and the whole build compiles as ONE ``jit`` program:

* coarse k-means++ / Lloyd over ``[N, M]`` — each Lloyd round runs per
  device under ``shard_map`` and ``psum``s the ``[K, M]`` cluster sums +
  ``[K]`` counts across the mesh (:mod:`.kmeans`);
* residual subtraction — local, no communication;
* batched PQ training over ``[D, N, M/D]`` — same sharded rounds per
  division, all divisions in flight at once;
* PQ encoding — local per device (:func:`_encode_sharded`).

Centroids and codebooks come back replicated; assignments and codes come back
sharded, ready for :func:`..parallel.query.query_sharded`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import kmeans
from .mesh import AXIS


#: Max rows used to TRAIN the PQ codebooks — a quality cap. Codebook
#: quality saturates at a few thousand samples per code (C=256 → 1M rows
#: is plenty; FAISS trains IVF-PQ on a sample for the same reason), while
#: training cost and the ``[D, N, M/D]`` division intermediate scale with
#: N. Above the cap, codebooks train on a uniform subsample and
#: full-corpus codes are assigned in a chunked pass.
PQ_TRAIN_CAP = 1 << 20

#: Max rows used to TRAIN the coarse (partition) centroids — a quality
#: cap, as :data:`PQ_TRAIN_CAP` one level up: centroid quality saturates
#: at a few hundred rows per centroid (2M rows = 512/centroid at P=4096 —
#: FAISS's coarse quantizer trains on a comparable sample), while every
#: Lloyd round is a full corpus pass. Above the cap the rounds run on a
#: uniform subsample and the full corpus gets one final assignment pass
#: (:func:`..ops.kmeans.fit` ``train_cap``).
COARSE_TRAIN_CAP = 2 << 20


class ShardedBuild(NamedTuple):
    """Device-resident build output.

    ``partition_centroids: [P, M]`` replicated; ``partition_indices: [N]``
    sharded (``uint16`` when ``P <= 65536``, else ``int32``); ``codebooks: [D, C, M/D]`` replicated; ``codes: [N, D]``
    sharded (``uint8`` when ``C <= 256`` — code values always fit, and the
    narrow dtype quarters both the device→host fetch and the device
    residency; else ``int32``). Host consumers widen on
    arrival (`build.py` → uint32, `..parallel.mesh.shard_corpus` → int32
    for the serving kernels).
    """
    partition_centroids: jax.Array
    partition_indices: jax.Array
    codebooks: jax.Array
    codes: jax.Array


def _code_dtype(c: int):
    """Narrowest dtype that holds PQ code values ``0..c-1``."""
    return jnp.uint8 if c <= 256 else jnp.int32


def _pidx_dtype(p: int):
    """Narrowest dtype that holds partition indices ``0..p-1`` (same
    fetch-width rationale as :func:`_code_dtype`)."""
    return jnp.uint16 if p <= (1 << 16) else jnp.int32


def _encode_chunked(x: jax.Array, cents: jax.Array, idx: jax.Array,
                    codebooks: jax.Array, *,
                    chunk: int = 1 << 16) -> jax.Array:
    """PQ-encodes corpus residuals against ``codebooks [D, C, M/D]``.

    ``codes[n, d] = argmin_c ||(x[n] - cents[idx[n]])_d - codebook[d, c]||²``
    streamed over row chunks. Residuals are computed PER CHUNK — neither a
    full-size residual array nor a divided ``[D, N, M/D]`` copy ever
    materializes next to the corpus. Transient: ``[chunk, D, C]``.
    """
    n, m = x.shape
    d, c, sub = codebooks.shape
    chunk = min(chunk, n)
    steps = -(-n // chunk)
    cc = jnp.sum(codebooks * codebooks, axis=-1)          # [D, C]

    def body(i, codes):
        # Last chunk shifts back; overlapping rows recompute identically.
        start = jnp.minimum(i * chunk, n - chunk)
        xi = jax.lax.dynamic_slice_in_dim(x, start, chunk, axis=0)
        ii = jax.lax.dynamic_slice_in_dim(idx, start, chunk, axis=0)
        r = (xi - jnp.take(cents, ii, axis=0)).reshape(chunk, d, sub)
        rc = jnp.einsum("nds,dcs->ndc", r, codebooks,
                        precision=kmeans._PRECISION,
                        preferred_element_type=jnp.float32)
        ci = jnp.argmin(cc[None] - 2.0 * rc, axis=-1).astype(_code_dtype(c))
        return jax.lax.dynamic_update_slice_in_dim(codes, ci, start,
                                                   axis=0)

    codes0 = jnp.zeros((n, d), _code_dtype(c))
    return jax.lax.fori_loop(0, steps, body, codes0)


def _build_fn(x: jax.Array, key: jax.Array, *, p: int, d: int, c: int,
              pq_cap: int = PQ_TRAIN_CAP,
              coarse_cap: int = COARSE_TRAIN_CAP,
              impl: str | None = None) -> ShardedBuild:
    """Single-device build body (``impl`` selects the Lloyd-round
    numerics, ``ops.kmeans._assign_precision``). The mesh path is
    :func:`_build_sharded_fn` (shard_map)."""
    n, m = x.shape
    k_coarse, k_pq, k_sub = jax.random.split(key, 3)

    coarse = kmeans.fit(x[None], p, k_coarse, impl=impl,
                        train_cap=coarse_cap)
    cents, idx = coarse.centroids[0], coarse.indices[0]
    if n > pq_cap:
        # Train codebooks on a uniform residual subsample
        # (with-replacement draws; duplicates only reweight the objective
        # negligibly at this cap), then assign full-corpus codes chunked
        # with per-chunk residuals — the corpus itself stays the only
        # full-size array in HBM.
        rows = jax.random.randint(k_sub, (pq_cap,), 0, n)
        sample = (jnp.take(x, rows, axis=0)
                  - jnp.take(cents, jnp.take(idx, rows), axis=0))
        divided = sample.reshape(pq_cap, d, m // d).transpose(1, 0, 2)
        pq = kmeans.fit(divided, c, k_pq, impl=impl)
        codes = _encode_chunked(x, cents, idx, pq.centroids)
    else:
        residues = x - jnp.take(cents, idx, axis=0)
        divided = residues.reshape(n, d, m // d).transpose(1, 0, 2)
        pq = kmeans.fit(divided, c, k_pq, impl=impl)
        codes = pq.indices.T.astype(_code_dtype(c))      # [N, D]
    return ShardedBuild(cents, idx.astype(_pidx_dtype(p)),
                        pq.centroids, codes)


_build_step = jax.jit(_build_fn,
                      static_argnames=("p", "d", "c", "pq_cap",
                                       "coarse_cap", "impl"))

#: Donating variant: the input buffer is released to XLA so the residual
#: array can alias it — for corpora within ~2× of device memory, where the
#: corpus and its residuals would not both fit. The caller's device array
#: is invalidated; re-``device_put`` to rebuild.
build_step_donating = jax.jit(_build_fn,
                              static_argnames=("p", "d", "c", "pq_cap",
                                               "coarse_cap", "impl"),
                              donate_argnums=(0,))


def build_staged(x: jax.Array, p: int, d: int, c: int, key: jax.Array,
                 events=None, *,
                 pq_cap: int = PQ_TRAIN_CAP,
                 coarse_cap: int = COARSE_TRAIN_CAP,
                 rounds_per_step: int = 8,
                 rounds_per_step_max: int = 32,
                 impl: str | None = None) -> ShardedBuild:
    """Host-stepped build for very large corpora (Deep10M-class).

    Identical math to :func:`_build_fn`, but each Lloyd round / stage runs
    as its OWN device program instead of one monolithic ``while_loop`` jit:
    the coarse phase host-steps via :func:`..ops.kmeans.fit_with_events`,
    which gives per-round progress events and a natural checkpoint seam
    for builds that outlive a serverless budget.

    ``rounds_per_step`` Lloyd rounds fuse into each program (``lax.scan``)
    so the per-program host round-trip amortizes. The per-program round
    count then DOUBLES up to ``rounds_per_step_max``
    (``ops.kmeans.fit_with_events``): a 100-round coarse fit dispatches
    a handful of programs (8+16+32+32+...) instead of 13, and rounds
    dispatched past convergence skip their corpus pass on device.

    ``impl`` as in :func:`..ops.kmeans.fit` (``"_fast"`` = fast numerics).
    """
    from .. import events as ev

    handler = events if events is not None else (lambda e: None)
    x = jnp.asarray(x, jnp.float32)
    n, m = x.shape
    k_coarse, k_pq, k_sub = jax.random.split(key, 3)

    coarse = kmeans.fit_with_events(x[None], p, k_coarse, handler,
                                    rounds_per_step=rounds_per_step,
                                    rounds_per_step_max=rounds_per_step_max,
                                    impl=impl,
                                    train_cap=coarse_cap)
    cents, idx = coarse.centroids[0], coarse.indices[0]

    handler(ev.StartingSubvectorDivision())
    if n > pq_cap:
        rows = jax.random.randint(k_sub, (pq_cap,), 0, n)
        sample = _sample_residuals(x, cents, idx, rows)
        divided = sample.reshape(pq_cap, d, m // d).transpose(1, 0, 2)
    else:
        divided = _all_residuals(x, cents, idx).reshape(
            n, d, m // d).transpose(1, 0, 2)
    handler(ev.FinishedSubvectorDivision())

    pq = kmeans.fit_with_events(divided, c, k_pq, handler,
                                rounds_per_step=rounds_per_step,
                                rounds_per_step_max=rounds_per_step_max,
                                impl=impl)
    if n > pq_cap:
        codes = _encode_jit(x, cents, idx, pq.centroids)
    else:
        # divided held ALL residuals, so the fit's own assignments ARE the
        # codes (exactly _build_fn's small branch) — re-encoding would
        # waste a full-corpus pass and could flip float ties.
        codes = pq.indices.T.astype(_code_dtype(c))
    return ShardedBuild(cents, idx.astype(_pidx_dtype(p)),
                        pq.centroids, codes)


@jax.jit
def _sample_residuals(x, cents, idx, rows):
    return (jnp.take(x, rows, axis=0)
            - jnp.take(cents, jnp.take(idx, rows), axis=0))


@jax.jit
def _all_residuals(x, cents, idx):
    return x - jnp.take(cents, idx, axis=0)


_encode_jit = jax.jit(_encode_chunked)


def _encode_sharded(x: jax.Array, cents: jax.Array, idx: jax.Array,
                    codebooks: jax.Array, mesh: Mesh) -> jax.Array:
    """Per-device chunked PQ encode (no collectives; codes stay sharded)."""
    return jax.shard_map(
        _encode_chunked, mesh=mesh,
        in_specs=(P(AXIS, None), P(), P(AXIS), P()),
        out_specs=P(AXIS, None),
        check_vma=False,
    )(x, cents, idx, codebooks)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "n", "p", "d", "c", "pq_cap",
                                    "coarse_cap", "impl"))
def _build_sharded_fn(x: jax.Array, key: jax.Array, *, mesh: Mesh, n: int,
                      p: int, d: int, c: int, pq_cap: int, coarse_cap: int,
                      impl: str | None) -> ShardedBuild:
    """One-program sharded build: the Lloyd rounds run per device under
    ``shard_map`` (:mod:`.kmeans`); everything between them —
    seeding, residuals, reshapes — is GSPMD-propagated XLA. Mirrors
    :func:`_build_fn` key-for-key so sharded and single-chip builds agree.

    ``x: [N', M]`` with rows ``>= n`` zero pads (``N'`` may already be
    shard-aligned by the caller; any remainder is padded here).
    """
    from .kmeans import fit_sharded

    m = x.shape[1]
    n_dev = mesh.devices.size
    xp = jnp.pad(x, ((0, (-x.shape[0]) % n_dev), (0, 0)))
    np_total = xp.shape[0]
    xp = jax.lax.with_sharding_constraint(
        xp, NamedSharding(mesh, P(AXIS, None)))
    rows_valid = jnp.arange(np_total) < n
    k_coarse, k_pq, k_sub = jax.random.split(key, 3)

    coarse = fit_sharded(xp[None], p, k_coarse, mesh=mesh, n_valid=n,
                         impl=impl, train_cap=coarse_cap)
    cents, idx = coarse.centroids[0], coarse.indices[0]    # idx [Np] sharded
    dspec = NamedSharding(mesh, P(None, AXIS, None))
    if n > pq_cap:
        rows = jax.random.randint(k_sub, (pq_cap,), 0, n)
        sample = (jnp.take(xp, rows, axis=0)
                  - jnp.take(cents, jnp.take(idx, rows), axis=0))
        spad = (-pq_cap) % n_dev
        sp = jnp.pad(sample, ((0, spad), (0, 0)))
        divided = jax.lax.with_sharding_constraint(
            sp.reshape(pq_cap + spad, d, m // d).transpose(1, 0, 2), dspec)
        pq = fit_sharded(divided, c, k_pq, mesh=mesh, n_valid=pq_cap,
                         impl=impl)
        codes = _encode_sharded(xp, cents, idx, pq.centroids, mesh)
    else:
        # Pad rows must stay zero: 0 - cents[garbage] would poison the
        # sharded PQ cluster sums (see .kmeans padding convention).
        residues = jnp.where(rows_valid[:, None],
                             xp - jnp.take(cents, idx, axis=0), 0.0)
        divided = jax.lax.with_sharding_constraint(
            residues.reshape(np_total, d, m // d).transpose(1, 0, 2), dspec)
        pq = fit_sharded(divided, c, k_pq, mesh=mesh, n_valid=n,
                         impl=impl)
        codes = pq.indices.T.astype(_code_dtype(c))
    return ShardedBuild(cents, idx[:n].astype(_pidx_dtype(p)),
                        pq.centroids, codes[:n])


def build_sharded(x, p: int, d: int, c: int, key: jax.Array, *,
                  mesh: Mesh, pq_cap: int = PQ_TRAIN_CAP,
                  coarse_cap: int = COARSE_TRAIN_CAP,
                  impl: str | None = None) -> ShardedBuild:
    """Builds the full IVF-PQ index with the corpus sharded over ``mesh``.

    ``x: [N, M]`` is placed row-sharded (zero-padded to the mesh size).
    The Lloyd rounds — the 906-second reference hot path — run per device
    under ``shard_map`` with one ``psum`` of the ``[K, M]`` sums + ``[K]``
    counts per round. ``impl`` as in :func:`..ops.kmeans.fit`.
    """
    from .mesh import pad_rows, put_global

    if not isinstance(x, jax.Array):
        arr = np.asarray(x, np.float32)
        n = arr.shape[0]
        x = put_global(pad_rows(arr, mesh.devices.size, 0.0),
                       NamedSharding(mesh, P(AXIS, None)))
    else:
        n = x.shape[0]
        x = jnp.asarray(x, jnp.float32)
    return _build_sharded_fn(x, key, mesh=mesh, n=n, p=p, d=d, c=c,
                             pq_cap=pq_cap, coarse_cap=coarse_cap,
                             impl=impl)
