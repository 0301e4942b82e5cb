"""Device-resident serving index shared by the in-memory and stored DBs.

Picks the query layout empirically (SURVEY.md §7 left this to measurement):

* **bucketed** (default): partition-major padded ``[P, D, L]`` buckets
  (:class:`.ops.bucketed.Buckets`) + a table lookup over the probed
  buckets only — work scales with ``nprobe × L``.
* **masked**: flat ``[N, D]`` codes + masked full scan — work scales with
  ``N``; chosen when partition-size skew would make bucket padding waste
  (``P·L > PAD_LIMIT × N``) outweigh pruning.

Both return identical results (global corpus rows); tests pin the
equivalence.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

#: Max tolerated padded-to-real ratio before falling back to the flat scan.
PAD_LIMIT = 4.0

#: Lazily-built jitted fused query+rerank program (jax is imported
#: lazily throughout this module; see :func:`_query_rerank_fused`).
_FUSED_RERANK = None


def _query_rerank_fused(*args, **kw):
    """One device program: bucketed ADC query (k=rerank candidates) →
    exact re-scoring against the originals → final top-k. Built lazily
    so importing :mod:`.serving` stays jax-free."""
    global _FUSED_RERANK
    if _FUSED_RERANK is None:
        import functools

        import jax
        import jax.numpy as jnp

        from .build import _rerank_exact
        from .ops.bucketed import query_bucketed

        @functools.partial(jax.jit,
                           static_argnames=("k", "nprobe", "rerank",
                                            "metric"))
        def fused(q, centroids, codebooks, buckets, rotation, row_mask,
                  originals, *, k, nprobe, rerank, metric):
            adc, rows, _ = query_bucketed(
                q, centroids, codebooks, buckets, rotation, row_mask,
                k=rerank, nprobe=nprobe, metric=metric)
            return _rerank_exact(
                q, rows, jnp.isfinite(adc), originals, k=k,
                metric="dot" if metric == "dot" else "l2")

        _FUSED_RERANK = fused
    return _FUSED_RERANK(*args, **kw)

#: Device-memory budget for the TRANSIENTS of one query batch on the
#: masked and range paths (ADC tables are ``[B, P, D, C]`` f32 — at SIFT
#: shape and B=1000 that alone is ~8 GB). Query batches are chunked so
#: transients stay under this; it bounds a batch, not the resident index.
#: Override per index via ``DeviceIndex(..., hbm_budget_bytes=...)``. See
#: docs/SCALING.md "Masked-scan memory bound".
HBM_BUDGET_BYTES = 2 << 30


def _masked_limit(cent_shape, cb_shape, n: int, budget: int,
                  metric: str = "l2") -> int:
    """Largest query batch whose masked-scan transients fit ``budget``.

    Per query the L2 masked path materializes the ADC tables ``[P, D, C]
    f32``, the residual intermediate ``[P, M] f32`` and the gather-sum
    ``[n, D] f32`` (``ops/adc.py``; ``n`` = rows scanned by one device);
    the bucketed path never blows up this way (per-probed-partition
    tables only). The dot path decomposes away the P-sized tables
    (``masked_scan_keys``): only a ``[D, C]`` table and the same
    ``[n, D]`` gather remain, so its batches can be much larger.
    """
    p, m = cent_shape
    d, c, _ = cb_shape
    if metric == "dot":
        per_query = 4 * (d * c + p + n * d)
    else:
        per_query = 4 * (p * d * c + p * m + n * d)
    return max(1, budget // per_query)


def _run_chunked(run, qd, limit: int):
    """Runs ``run(q_chunk)`` over fixed-size query chunks and concatenates
    the outputs (any arity) on the host.

    The tail chunk is zero-padded up to ``limit`` (pad results sliced off)
    so every iteration reuses ONE compiled program — a distinct tail shape
    would otherwise cost a second compile.
    """
    import jax.numpy as jnp

    b = len(qd)
    if b <= limit:
        return tuple(np.asarray(x) for x in run(qd))
    outs = []
    for i in range(0, b, limit):
        chunk = qd[i:i + limit]
        pad = limit - len(chunk)
        if pad:
            chunk = jnp.pad(chunk, ((0, pad), (0, 0)))
        outs.append(tuple(
            np.asarray(x)[:limit - pad] for x in run(chunk)))
    return tuple(np.concatenate([o[j] for o in outs])
                 for j in range(len(outs[0])))


def _range_limit(nprobe: int, l: int, cb_shape, budget: int) -> int:
    """Largest query batch whose bucketed range-scan transients fit
    ``budget``: per query the probed tables ``[nprobe, D, C] f32`` plus
    the gathered keys+rows ``[nprobe, L] f32+i32`` (×2 for the combine's
    second live copy)."""
    d, c, _ = cb_shape
    per_query = 4 * nprobe * (d * c + 4 * l)
    return max(1, budget // per_query)


def _range_host_tail(keys: np.ndarray, rows: np.ndarray,
                     radius: float) -> list:
    """Thresholds device range-scan candidates (``+inf`` = non-candidate)
    into per-query ``(rows int64[], keys f32[])`` pairs, key-ascending —
    shared by the single-chip and sharded serving tiers."""
    out = []
    for b in range(len(keys)):
        hit = keys[b] <= radius
        kb, rb = keys[b][hit], rows[b][hit]
        order = np.argsort(kb, kind="stable")
        out.append((rb[order].astype(np.int64), kb[order]))
    return out


def _choose_layout(p: int, pidx: np.ndarray, n: int) -> str:
    """Bucketed (pruned) unless partition skew makes the ``[P, L_pad]``
    bucket padding blow past ``PAD_LIMIT``× the flat corpus — the one
    policy both single-chip and sharded serving must agree on."""
    counts = np.bincount(pidx, minlength=p) if len(pidx) else [1]
    l_pad = -(-int(max(max(counts), 1)) // 128) * 128   # as bucketize
    return "bucketed" if p * l_pad <= PAD_LIMIT * max(n, 128) else "masked"


class DeviceIndex:
    """IVF-PQ index pushed to device memory, ready for batched queries."""

    def __init__(self, centroids: np.ndarray, codebooks: np.ndarray,
                 codes: np.ndarray, pidx: np.ndarray,
                 layout: Optional[str] = None,
                 rotation: Optional[np.ndarray] = None,
                 hbm_budget_bytes: int = HBM_BUDGET_BYTES,
                 metric: str = "l2") -> None:
        import jax.numpy as jnp

        from .metrics import check_metric
        from .ops.bucketed import bucketize

        self.hbm_budget_bytes = hbm_budget_bytes
        # Kernel-level metric: cosine is L2 over unit vectors — the
        # DATABASE layer normalizes corpus/queries; kernels see "l2".
        m = check_metric(metric)
        self.metric = "dot" if m == "dot" else "l2"

        p = centroids.shape[0]
        n = max(len(codes), 1)
        if layout is None:
            layout = _choose_layout(p, pidx, n)
        self.layout = layout
        self.centroids = jnp.asarray(centroids)
        self.codebooks = jnp.asarray(codebooks)
        self.rotation = None if rotation is None else jnp.asarray(rotation)
        if layout == "bucketed":
            # pack="auto": four byte codes per word when C <= 256 — 4×
            # less resident HBM and 4× less bucket-gather traffic.
            self.buckets = bucketize(
                np.asarray(codes, np.int32), np.asarray(pidx, np.int32), p,
                pack="auto")
            self.codes = self.pidx = None
        elif layout == "masked":
            self.codes = jnp.asarray(np.asarray(codes, np.int32))
            self.pidx = jnp.asarray(np.asarray(pidx, np.int32))
            self.buckets = None
        else:
            raise ValueError(f"unknown layout: {layout!r}")

    def _masked_batch_limit(self) -> int:
        """Largest query batch whose masked-scan transients fit the budget
        (see :func:`_masked_limit`)."""
        return _masked_limit(self.centroids.shape, self.codebooks.shape,
                             self.codes.shape[0], self.hbm_budget_bytes,
                             self.metric)

    def query(self, q: np.ndarray, k: int, nprobe: int,
              row_mask=None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched k-NN: ``q [B, M]`` → host ``(dists, rows, probed)``.

        ``row_mask [N] bool`` (device array or numpy, optional) excludes
        corpus rows before top-k (attribute filtering, :mod:`.filters`).

        Masked-layout batches are chunked so per-batch transients stay
        under ``hbm_budget_bytes`` (a skewed corpus forcing the masked
        fallback must not run out of device memory on large batches).
        """
        import jax.numpy as jnp

        from .ops.adc import query_masked_scan
        from .ops.bucketed import query_bucketed

        qd = jnp.asarray(np.asarray(q, np.float32))
        if row_mask is not None:
            row_mask = jnp.asarray(row_mask, bool)
        if self.layout == "bucketed":
            d, r, p = query_bucketed(
                qd, self.centroids, self.codebooks, self.buckets,
                self.rotation, row_mask, k=k, nprobe=nprobe,
                metric=self.metric)
            return np.asarray(d), np.asarray(r), np.asarray(p)

        return _run_chunked(
            lambda qc: query_masked_scan(
                qc, self.centroids, self.codebooks, self.codes, self.pidx,
                self.rotation, row_mask, k=k, nprobe=nprobe,
                metric=self.metric),
            qd, self._masked_batch_limit())

    def query_rerank(self, q: np.ndarray, originals, k: int, nprobe: int,
                     rerank: int, row_mask=None,
                     ) -> tuple[np.ndarray, np.ndarray]:
        """ADC query + EXACT re-scoring of the top ``rerank`` candidates
        against ``originals [N, M]`` (device array), fused into ONE
        device program on the bucketed layout.

        The two-step form (query → fetch candidates to host → re-score)
        pays a full host round trip (a dispatch + transfer) between the
        stages. Returns host
        ``(dists [B, k], rows [B, k])``.
        """
        import jax.numpy as jnp

        qd = jnp.asarray(np.asarray(q, np.float32))
        if row_mask is not None:
            row_mask = jnp.asarray(row_mask, bool)
        if self.layout == "bucketed":
            d, r = _query_rerank_fused(
                qd, self.centroids, self.codebooks, self.buckets,
                self.rotation, row_mask, originals, k=k, nprobe=nprobe,
                rerank=rerank, metric=self.metric)
            return np.asarray(d), np.asarray(r)
        # Masked layout: keep the two-step path (rare fallback; its
        # batches are chunked for HBM anyway).
        from .build import _rerank_exact
        adc, rows, _ = self.query(q, rerank, nprobe, row_mask=row_mask)
        d, r = _rerank_exact(
            qd, jnp.asarray(rows), jnp.asarray(np.isfinite(adc)),
            originals, k=k,
            metric="dot" if self.metric == "dot" else "l2")
        return np.asarray(d), np.asarray(r)

    def query_range(self, q: np.ndarray, radius: float, nprobe: int,
                    row_mask=None) -> list:
        """Range search: per query, ``(rows, keys)`` of every probed
        vector whose ranking key is ``<= radius`` (squared distance for
        L2/cosine; negated inner product for dot — pass ``-min_ip``),
        ascending. Returns a list of ``(rows int64[], keys f32[])``
        pairs. The device scans the probed buckets/rows; thresholding
        and ragged extraction happen host-side, so the transfer is the
        full candidate key array. Query batches are chunked so device
        transients stay under ``hbm_budget_bytes`` (same policy as
        :meth:`query`'s masked path).
        """
        import jax.numpy as jnp

        from .ops.adc import range_masked_scan
        from .ops.bucketed import range_bucketed

        qd = jnp.asarray(np.asarray(q, np.float32))
        if row_mask is not None:
            row_mask = jnp.asarray(row_mask, bool)
        if self.layout == "bucketed":
            keys, rows = _run_chunked(
                lambda qc: range_bucketed(
                    qc, self.centroids, self.codebooks, self.buckets,
                    self.rotation, row_mask, nprobe=nprobe,
                    metric=self.metric)[:2],
                qd, _range_limit(nprobe, self.buckets.codes.shape[2],
                                 self.codebooks.shape,
                                 self.hbm_budget_bytes))
        else:
            keys, = _run_chunked(
                lambda qc: range_masked_scan(
                    qc, self.centroids, self.codebooks, self.codes,
                    self.pidx, self.rotation, row_mask, nprobe=nprobe,
                    metric=self.metric)[:1],
                qd, self._masked_batch_limit())
            rows = np.broadcast_to(
                np.arange(keys.shape[1], dtype=np.int32), keys.shape)
        return _range_host_tail(keys, rows, radius)


class ShardedIndex:
    """IVF-PQ index sharded across a device mesh (SPMD serving).

    Same ``query`` contract as :class:`DeviceIndex`, and the same two
    layouts: **bucketed** (default — the :class:`..ops.bucketed.Buckets`
    arrays shard on the PARTITION axis and each device scans only the
    probed buckets it owns, :mod:`.parallel.bucketed`) or **masked**
    (corpus rows shard; every device scans all its local rows,
    :mod:`.parallel.query`). Either way only ``k`` candidates per device
    cross the interconnect. ``self.layout`` is ``"sharded-bucketed"`` /
    ``"sharded-masked"``.
    """

    def __init__(self, centroids: np.ndarray, codebooks: np.ndarray,
                 codes: np.ndarray, pidx: np.ndarray,
                 layout: Optional[str] = None,
                 rotation: Optional[np.ndarray] = None,
                 hbm_budget_bytes: int = HBM_BUDGET_BYTES,
                 metric: str = "l2", *, mesh) -> None:
        import jax.numpy as jnp

        from .metrics import check_metric
        from .ops.bucketed import bucketize
        from .parallel.bucketed import shard_buckets
        from .parallel.mesh import shard_corpus

        self.mesh = mesh
        self.hbm_budget_bytes = hbm_budget_bytes
        m = check_metric(metric)  # cosine normalizes upstream; see DeviceIndex
        self.metric = "dot" if m == "dot" else "l2"
        self.centroids = jnp.asarray(centroids)
        self.codebooks = jnp.asarray(codebooks)
        self.rotation = None if rotation is None else jnp.asarray(rotation)

        p = centroids.shape[0]
        n = max(len(codes), 1)
        if layout is None:
            layout = _choose_layout(p, pidx, n)
        if layout == "bucketed":
            self.buckets = shard_buckets(mesh, bucketize(
                np.asarray(codes, np.int32), np.asarray(pidx, np.int32), p,
                pack="auto"))
            self.codes = self.pidx = None
        elif layout == "masked":
            self.codes, self.pidx = shard_corpus(
                mesh, np.asarray(codes, np.int32),
                np.asarray(pidx, np.int32))
            self.buckets = None
        else:
            raise ValueError(f"unknown layout: {layout!r}")
        self.layout = f"sharded-{layout}"

    def query(self, q: np.ndarray, k: int, nprobe: int,
              row_mask=None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        import jax.numpy as jnp

        from .parallel.bucketed import query_bucketed_sharded
        from .parallel.mesh import shard_mask
        from .parallel.query import query_sharded

        qd = jnp.asarray(np.asarray(q, np.float32))
        if self.layout == "sharded-bucketed":
            if row_mask is not None:
                row_mask = jnp.asarray(row_mask, bool)  # replicated, global
            d, r, p = query_bucketed_sharded(
                qd, self.centroids, self.codebooks, self.buckets,
                self.rotation, row_mask, mesh=self.mesh, k=k, nprobe=nprobe,
                metric=self.metric)
            return np.asarray(d), np.asarray(r), np.asarray(p)
        if row_mask is not None:
            row_mask = shard_mask(self.mesh, np.asarray(row_mask, bool))
        # The query batch is replicated, so every device materializes the
        # full [B, P, D, C] ADC tables — chunk by the same budget as the
        # single-chip masked path (per-device scanned rows = N / n_dev).
        n_local = self.codes.shape[0] // int(self.mesh.devices.size)
        limit = _masked_limit(self.centroids.shape, self.codebooks.shape,
                              n_local, self.hbm_budget_bytes, self.metric)
        return _run_chunked(
            lambda qc: query_sharded(
                qc, self.centroids, self.codebooks, self.codes, self.pidx,
                self.rotation, row_mask, mesh=self.mesh, k=k,
                nprobe=nprobe, metric=self.metric),
            qd, limit)

    def query_range(self, q: np.ndarray, radius: float, nprobe: int,
                    row_mask=None) -> list:
        """Range search over the sharded index — same contract as
        :meth:`DeviceIndex.query_range` (per-query ``(rows, keys)`` pairs,
        ascending). Each device scans the probed buckets/rows it owns;
        the candidate arrays combine across the mesh (``pmin``/``psum`` —
        range results ARE the candidate set, so the full array crosses,
        unlike the k-best query merge) and the host thresholds once.
        """
        import jax.numpy as jnp

        from .parallel.bucketed import range_bucketed_sharded
        from .parallel.mesh import shard_mask
        from .parallel.query import range_sharded

        qd = jnp.asarray(np.asarray(q, np.float32))
        if self.layout == "sharded-bucketed":
            if row_mask is not None:
                row_mask = jnp.asarray(row_mask, bool)  # replicated, global
            keys, rows = _run_chunked(
                lambda qc: range_bucketed_sharded(
                    qc, self.centroids, self.codebooks, self.buckets,
                    self.rotation, row_mask, mesh=self.mesh, nprobe=nprobe,
                    metric=self.metric)[:2],
                qd, _range_limit(nprobe, self.buckets.codes.shape[2],
                                 self.codebooks.shape,
                                 self.hbm_budget_bytes))
        else:
            if row_mask is not None:
                row_mask = shard_mask(self.mesh, np.asarray(row_mask, bool))
            n_local = self.codes.shape[0] // int(self.mesh.devices.size)
            keys, = _run_chunked(
                lambda qc: range_sharded(
                    qc, self.centroids, self.codebooks, self.codes,
                    self.pidx, self.rotation, row_mask, mesh=self.mesh,
                    nprobe=nprobe, metric=self.metric)[:1],
                qd, _masked_limit(self.centroids.shape,
                                  self.codebooks.shape, n_local,
                                  self.hbm_budget_bytes, self.metric))
            rows = np.broadcast_to(
                np.arange(keys.shape[1], dtype=np.int32), keys.shape)
        return _range_host_tail(keys, rows, radius)
