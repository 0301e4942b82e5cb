"""Database builder and in-memory database.

Reference (``src/db/build.rs``): ``DatabaseBuilder`` (defaults P=10, D=8,
C=16, ``build.rs:44-52``) runs UUID assignment → IVF partitioning →
sub-vector division → per-division PQ clustering (``build.rs:78-129``); the
resulting in-memory ``Database`` supports attribute set/get
(``build.rs:228-285``) and k-NN queries (``build.rs:293-382, 521-565``).

Device-first build pipeline — three device programs instead of ~1300 scalar
k-means passes:

1. coarse k-means++ / Lloyd over ``[N, M]`` (one batch row),
2. residual subtraction (fused gather),
3. *batched* PQ training: all ``D`` division codebooks in one program over
   ``[D, N, M/D]`` (the reference loops divisions sequentially at
   ``build.rs:110-118``).

Queries run as one fused masked-scan kernel (see ``ops/adc.py``) and are
batched: ``query_batch`` amortizes dispatch over many query vectors.
"""

from __future__ import annotations

import functools
import uuid as _uuid
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import events as ev
from .attributes import AttributeTable, AttributeValue, \
    check_attribute_value
from .errors import InvalidArgs
from .events import EventHandler, _noop
from .ops import kmeans
from .partitions import partition
from .vector import as_vector_set, divide_vector_set


def _make_uuids(n: int, rng: np.random.Generator) -> List[_uuid.UUID]:
    """Random version-4 UUIDs (``build.rs:86-91``), reproducible via rng."""
    raw = rng.integers(0, 256, size=(n, 16), dtype=np.uint8)
    raw[:, 6] = (raw[:, 6] & 0x0F) | 0x40  # version 4
    raw[:, 8] = (raw[:, 8] & 0x3F) | 0x80  # RFC 4122 variant
    return [_uuid.UUID(bytes=row.tobytes()) for row in raw]


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _rerank_exact(q, rows, valid, x, *, k, metric="l2"):
    """Exact re-scoring of ADC candidates.

    ``q [B, M]``, ``rows [B, R]`` candidate corpus rows, ``valid [B, R]``
    (False where the ADC pass ran out of reachable vectors), ``x [N, M]``
    originals → exact ``(dists [B, k], rows [B, k])``. ``metric="dot"``
    re-scores by ``−⟨q, x⟩`` (see :mod:`.metrics`); cosine callers pass
    unit vectors and the L2 key.
    """
    cand = jnp.take(x, rows, axis=0)                    # [B, R, M]
    if metric == "dot":
        exact = -jnp.einsum("bm,brm->br", q, cand,
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)
    else:
        diff = cand - q[:, None, :]
        exact = jnp.sum(diff * diff, axis=-1)
    exact = jnp.where(valid, exact, jnp.inf)
    neg, sel = jax.lax.top_k(-exact, k)
    return -neg, jnp.take_along_axis(rows, sel, axis=1)


def _local_indices(pidx: np.ndarray, p: int) -> np.ndarray:
    """Rank of each vector inside its partition, preserving input order.

    Matches the reference's implicit ordering: a partition's members appear
    in original input order (``build.rs:462-472``), and ``vector_index`` in
    query results is that local rank (``build.rs:546-562``).
    """
    order = np.argsort(pidx, kind="stable")
    sorted_p = pidx[order]
    starts = np.searchsorted(sorted_p, np.arange(p), side="left")
    local = np.empty(len(pidx), dtype=np.int32)
    local[order] = np.arange(len(pidx), dtype=np.int32) - starts[sorted_p]
    return local


@dataclass
class QueryResult:
    """One k-NN result (``build.rs:576-587``)."""
    partition_index: int
    vector_id: _uuid.UUID
    vector_index: int          # local index within the partition
    squared_distance: float


class DatabaseBuilder:
    """Fluent builder (``build.rs:23-70``); defaults P=10, D=8, C=16.

    ``dtype``: ``np.float32`` (default) builds on the device pipeline.
    ``np.float64`` routes the BUILD through the f64 host oracle
    (:mod:`.oracle` — the dtype-generic path mirroring the reference's
    trait-ready ``numbers.rs:6-111``); the resulting :class:`Database`
    serves from f32 device arrays via a checked cast (values that would
    overflow f32 raise :class:`InvalidArgs`), matching the reference's
    implemented surface (f32-only serving, ``README.md:54,63``).
    """

    def __init__(self, vs, dtype=np.float32) -> None:
        dt = np.dtype(dtype)
        if dt == np.float64:
            arr = np.asarray(vs, np.float64)
            if arr.ndim != 2:
                raise InvalidArgs(
                    f"f64 build needs an [N, M] array, got {arr.shape}")
            self._vs = arr
        elif dt == np.float32:
            self._vs = as_vector_set(vs)
        else:
            raise InvalidArgs(f"unsupported build dtype: {dt}")
        self._dtype = dt.type
        self._num_partitions = 10
        self._num_divisions = 8
        self._num_clusters = 16
        self._seed: Optional[int] = None
        self._opq_iters: int = 0
        self._metric = "l2"
        self._impl: Optional[str] = None
        self._keep_residues = True

    def with_partitions(self, p: int) -> "DatabaseBuilder":
        if p <= 0:
            raise InvalidArgs(f"num_partitions must be positive: {p}")
        self._num_partitions = p
        return self

    def with_divisions(self, d: int) -> "DatabaseBuilder":
        if d <= 0:
            raise InvalidArgs(f"num_divisions must be positive: {d}")
        self._num_divisions = d
        return self

    def with_clusters(self, c: int) -> "DatabaseBuilder":
        if c <= 0:
            raise InvalidArgs(f"num_clusters must be positive: {c}")
        self._num_clusters = c
        return self

    def with_opq(self, iters: int = 8) -> "DatabaseBuilder":
        """Enables OPQ: a learned orthogonal rotation before PQ
        (:mod:`.ops.opq`) that reduces quantization error at equal code
        memory. EXTENSION: databases saved with a rotation are not readable
        by the reference implementation."""
        if iters <= 0:
            raise InvalidArgs(f"opq iters must be positive: {iters}")
        self._opq_iters = iters
        return self

    def with_metric(self, metric: str) -> "DatabaseBuilder":
        """Sets the query metric: ``"l2"`` (default, the reference's),
        ``"dot"`` (maximum inner product) or ``"cosine"`` (corpus and
        queries are unit-normalized; zero vectors raise). EXTENSION — see
        :mod:`.metrics`; non-L2 databases save with root extension field
        21 and would be served as L2 by the reference (same caveat as
        OPQ's field 20)."""
        from .metrics import check_metric
        self._metric = check_metric(metric)
        return self

    def with_fast_math(self, on: bool = True) -> "DatabaseBuilder":
        """Drops the clustering assignment matmuls from ``Precision.HIGH``
        to ``Precision.DEFAULT``.

        EXTENSION. On NVIDIA GPUs with TF32 tensor cores this changes
        nothing: XLA compiles both precisions to the same TF32 cuBLAS
        GEMM (checked on an H100 from the compiled HLO; the results are
        identical). Where a backend makes DEFAULT cheaper and coarser than
        HIGH, near-equal distances may assign differently. Applies to
        TRAINING only: query-path distances keep ``Precision.HIGHEST``
        regardless. Not supported together with ``dtype=np.float64`` (the
        oracle is exact by design)."""
        self._impl = "_fast" if on else None
        return self

    def with_seed(self, seed: int) -> "DatabaseBuilder":
        """Fixes the RNG for clustering *and* UUID assignment.

        The seed fixes every random draw, but float32 sums are not always
        taken in the same order (XLA autotuning across recompiles, a
        GPU's atomic adds in the cluster sums), which can perturb the
        (chaotic) k-means trajectory — compare builds by quality
        (inertia/recall), not bits, as with the reference's
        ``thread_rng`` (SURVEY.md §7).
        """
        self._seed = seed
        return self

    def with_residues(self, keep: bool = True) -> "DatabaseBuilder":
        """Whether the built database retains per-vector residues.

        Residues back the beyond-reference conveniences — exact
        :meth:`Database.rerank` and :meth:`Database.get_vector`
        reconstruction — at ``N·M·4`` bytes of host RAM and, when the
        corpus lives on an accelerator, a full-corpus device→host fetch
        inside :meth:`build` (614 MB at the reference's headline shape).
        ``with_residues(False)`` skips retention;
        those two methods then raise :class:`InvalidArgs`, exactly like
        a reference database, which stores only codes (db/build.rs
        builds encoded partitions; raw vectors are dropped).
        """
        self._keep_residues = keep
        return self

    def build_with_events(self, events: EventHandler) -> "Database":
        """Name-parity alias for :meth:`build` (``build.rs:73-78``)."""
        return self.build(events)

    def build(self, events: EventHandler = _noop) -> "Database":
        """Runs the build pipeline (``build.rs:78-129``)."""
        x = self._vs
        if self._metric == "cosine":
            from .metrics import normalize_rows
            x = normalize_rows(x)
        n, m = x.shape
        p, d, c = (self._num_partitions, self._num_divisions,
                   self._num_clusters)
        if n < p:
            raise InvalidArgs(f"vs has fewer vectors than k: {n} < {p}")
        if n < c:
            raise InvalidArgs(f"vs has fewer vectors than k: {n} < {c}")
        if m % d != 0:
            raise InvalidArgs(f"vector size ({m}) is not divisible by {d}")

        seed = (np.random.SeedSequence().entropy if self._seed is None
                else self._seed)
        rng = np.random.default_rng(seed)
        key = jax.random.key(int(np.uint32(rng.integers(0, 2**32))))
        k_coarse, k_pq = jax.random.split(key)

        events(ev.StartingIdAssignment())
        vector_ids = _make_uuids(n, rng)
        events(ev.FinishedIdAssignment())

        if self._dtype == np.float64:
            if self._impl is not None:
                raise InvalidArgs(
                    "with_fast_math() is not supported for dtype=float64 "
                    "(the host oracle is exact by design)")
            return self._build_f64(x, p, d, c, rng, vector_ids, events)

        events(ev.StartingPartitioning())
        cluster_events = ((lambda e: events(ev.ClusterEvent(e)))
                          if events is not _noop else _noop)
        parts = partition(jnp.asarray(x), p, k_coarse, events=cluster_events,
                          impl=self._impl)
        events(ev.FinishedPartitioning())

        events(ev.StartingSubvectorDivision())
        divided = divide_vector_set(parts.residues, d)   # [D, N, m]
        events(ev.FinishedSubvectorDivision())

        # All D division codebooks train in one batched program; emit the
        # reference's per-division event pairs around it (build.rs:110-118).
        for i in range(d):
            events(ev.StartingQuantization(i))
        rotation = None
        if self._opq_iters:
            from .ops.opq import fit_opq
            opq = fit_opq(parts.residues, d, c, k_pq,
                          iters=self._opq_iters, impl=self._impl)
            rotation, pq = np.asarray(opq.rotation), opq.pq
        elif events is _noop:
            pq = kmeans.fit(divided, c, k_pq, impl=self._impl)
        else:
            pq = kmeans.fit_with_events(divided, c, k_pq, cluster_events,
                                        impl=self._impl)
        for i in range(d):
            events(ev.FinishedQuantization(i))

        # Overlap the device→host fetches: start every copy before the
        # first blocking np.asarray (the residual fetch alone is hundreds
        # of MB; async launch lets the transfers stream while the host
        # materializes the small arrays).
        outs = [parts.centroids, parts.indices, pq.centroids, pq.indices]
        if self._keep_residues:
            outs.append(parts.residues)
        for a in outs:
            if hasattr(a, "copy_to_host_async"):
                a.copy_to_host_async()
        pidx = np.asarray(parts.indices, dtype=np.int32)
        return Database(
            vector_size=m,
            num_partitions=p,
            num_divisions=d,
            num_clusters=c,
            vector_ids=vector_ids,
            partition_centroids=np.asarray(parts.centroids),
            partition_indices=pidx,
            codebooks=np.asarray(pq.centroids),
            codes=np.asarray(pq.indices, dtype=np.uint32).T.copy(),
            residues=(np.asarray(parts.residues)
                      if self._keep_residues else None),
            rotation=rotation,
            metric=self._metric,
        )

    def _build_f64(self, x, p, d, c, rng, vector_ids,
                   events: EventHandler) -> "Database":
        """f64 build via the host oracle (the dtype seam).

        Training runs end-to-end in float64 (``oracle.build`` — the
        reference's would-be f64 instantiation of its generic stack);
        serving arrays cast to f32 with an overflow check, since the
        device path (and the wire format, ``database.proto:66-72``) is
        f32.
        """
        from . import oracle

        if self._opq_iters:
            raise InvalidArgs("OPQ is not supported on the f64 build path")

        events(ev.StartingPartitioning())
        ob = oracle.build(x, p, d, c, rng, dtype=np.float64)
        events(ev.FinishedPartitioning())
        events(ev.StartingSubvectorDivision())
        residues64 = x - ob.partition_centroids[ob.partition_indices]
        events(ev.FinishedSubvectorDivision())
        for i in range(d):
            events(ev.StartingQuantization(i))
            events(ev.FinishedQuantization(i))

        def cast32(a, what):
            import warnings

            with np.errstate(over="ignore"), warnings.catch_warnings():
                # Overflow is detected and reported as InvalidArgs below.
                warnings.simplefilter("ignore", RuntimeWarning)
                out = a.astype(np.float32)
            if np.isinf(out[np.isfinite(a)]).any():
                raise InvalidArgs(
                    f"f64 {what} overflows f32 serving range")
            return out

        return Database(
            vector_size=x.shape[1],
            num_partitions=p,
            num_divisions=d,
            num_clusters=c,
            vector_ids=vector_ids,
            partition_centroids=cast32(ob.partition_centroids,
                                       "partition centroids"),
            partition_indices=np.asarray(ob.partition_indices, np.int32),
            codebooks=cast32(ob.codebooks, "codebooks"),
            codes=np.asarray(ob.codes, np.uint32),
            residues=(cast32(residues64, "residues")
                      if self._keep_residues else None),
            rotation=None,
            metric=self._metric,
        )


@dataclass
class Database:
    """In-memory database (``build.rs:156-286``).

    Host state is numpy; device mirrors are created lazily on first query and
    reused across queries (the "warm" path).
    """
    vector_size: int
    num_partitions: int
    num_divisions: int
    num_clusters: int
    vector_ids: List[_uuid.UUID]
    partition_centroids: np.ndarray          # [P, M] f32
    partition_indices: np.ndarray            # [N] int32
    codebooks: np.ndarray                    # [D, C, m] f32
    codes: np.ndarray                        # [N, D] uint32
    residues: Optional[np.ndarray] = None    # [N, M] f32 (for reconstruction)
    rotation: Optional[np.ndarray] = None    # [M, M] OPQ rotation (extension)
    metric: str = "l2"                       # see metrics.py (extension)
    attribute_table: AttributeTable = field(default_factory=dict)

    _local_idx: Optional[np.ndarray] = field(default=None, repr=False)
    _dev: Optional[tuple] = field(default=None, repr=False)
    _dev_orig: Optional[object] = field(default=None, repr=False)
    _filter_cache: Optional[object] = field(default=None, repr=False)

    # -- basic accessors (build.rs:178-224) --------------------------------

    @property
    def num_vectors(self) -> int:
        return len(self.vector_ids)

    @property
    def subvector_size(self) -> int:
        return self.vector_size // self.num_divisions

    @property
    def local_indices(self) -> np.ndarray:
        if self._local_idx is None:
            self._local_idx = _local_indices(
                self.partition_indices, self.num_partitions)
        return self._local_idx

    def reconstruct(self, i: int) -> np.ndarray:
        """Original input vector i = residue + centroid
        (``partitions.rs:68-93``)."""
        if self.residues is None:
            raise InvalidArgs("residues were not retained")
        return (self.residues[i]
                + self.partition_centroids[self.partition_indices[i]])

    # -- updates ("Update database", reference README.md:73) -----------------

    def add_vectors(self, vs,
                    vector_ids: Optional[List[_uuid.UUID]] = None,
                    seed: Optional[int] = None) -> List[_uuid.UUID]:
        """Adds vectors to the built index without retraining.

        New vectors are assigned to their nearest existing partition and
        PQ-encoded with the existing codebooks (:mod:`.ops.encode`).
        Because the storage format is content-addressed, re-saving after an
        append rewrites only the touched partitions' files plus the root
        manifest — untouched partitions keep their hashes (and therefore
        their files). This is the "Update database" roadmap item the
        reference leaves open (``README.md:73``).
        """
        from .ops.encode import encode

        x = as_vector_set(vs, self.vector_size)
        if self.metric == "cosine":
            from .metrics import normalize_rows
            x = normalize_rows(x)
        if vector_ids is None:
            vector_ids = _make_uuids(len(x), np.random.default_rng(seed))
        if len(vector_ids) != len(x):
            raise InvalidArgs(
                f"{len(vector_ids)} IDs for {len(x)} vectors")
        import jax.numpy as jnp
        rot = None if self.rotation is None else jnp.asarray(self.rotation)
        pidx, codes = encode(
            jnp.asarray(x), jnp.asarray(self.partition_centroids),
            jnp.asarray(self.codebooks), rot)
        self.partition_indices = np.concatenate(
            [self.partition_indices, np.asarray(pidx, np.int32)])
        self.codes = np.concatenate(
            [self.codes, np.asarray(codes).astype(np.uint32)])
        if self.residues is not None:
            res = x - self.partition_centroids[np.asarray(pidx)]
            self.residues = np.concatenate([self.residues, res])
        self.vector_ids.extend(vector_ids)
        self._dev = None
        self._dev_orig = None
        self._local_idx = None
        self._invalidate_filters()
        return list(vector_ids)

    def remove_vectors(self, vector_ids: Iterable[_uuid.UUID]) -> int:
        """Removes vectors by ID; returns the number removed.

        Complements :meth:`add_vectors` ("Update database",
        ``README.md:73``): unknown IDs raise :class:`InvalidArgs` (the
        reference's unknown-vector-ID behaviour, ``build.rs:236-240``).
        Because the storage format is content-addressed, re-saving after a
        removal rewrites only the partitions that lost members — untouched
        partitions keep their hashes and therefore their files.
        """
        doomed = set(vector_ids)
        if not doomed:
            return 0
        row_of = {vid: i for i, vid in enumerate(self.vector_ids)}
        missing = [vid for vid in doomed if vid not in row_of]
        if missing:
            raise InvalidArgs(f"no such vector ID: {missing[0]}")
        keep = np.ones(self.num_vectors, bool)
        keep[[row_of[vid] for vid in doomed]] = False
        self.vector_ids = [vid for vid, kp in zip(self.vector_ids, keep)
                           if kp]
        self.partition_indices = self.partition_indices[keep]
        self.codes = self.codes[keep]
        if self.residues is not None:
            self.residues = self.residues[keep]
        for vid in doomed:
            self.attribute_table.pop(vid, None)
        self._dev = None
        self._dev_orig = None
        self._local_idx = None
        self._invalidate_filters()
        return len(doomed)

    # -- attributes (build.rs:228-285) --------------------------------------

    def get_attribute(self, vector_id: _uuid.UUID,
                      key: str) -> Optional[AttributeValue]:
        try:
            attrs = self.attribute_table[vector_id]
        except KeyError:
            raise InvalidArgs(f"no such vector ID: {vector_id}") from None
        return attrs.get(key)

    def set_attribute_at(self, i: int, attribute: Tuple[str, AttributeValue],
                         ) -> None:
        if not 0 <= i < self.num_vectors:
            raise InvalidArgs(f"vector index out of bounds: {i}")
        key, value = attribute
        value = check_attribute_value(value)
        vid = self.vector_ids[i]
        self.attribute_table.setdefault(vid, {})[str(key)] = value
        self._invalidate_filters()

    # -- attribute filtering (EXTENSION, see filters.py) ----------------------

    def _invalidate_filters(self) -> None:
        if self._filter_cache is not None:
            self._filter_cache.invalidate()

    def _filter_mask(self, where) -> np.ndarray:
        from .filters import ColumnCache, evaluate_mask
        if self._filter_cache is None:
            self._filter_cache = ColumnCache()
        return evaluate_mask(where, self.vector_ids, self.attribute_table,
                             self._filter_cache)

    # -- queries (build.rs:293-382) ------------------------------------------

    def _device_state(self):
        if self._dev is None:
            from .serving import DeviceIndex
            self._dev = DeviceIndex(
                self.partition_centroids, self.codebooks,
                self.codes.astype(np.int32), self.partition_indices,
                rotation=self.rotation, metric=self.metric)
        return self._dev

    def _prep_queries(self, vs: np.ndarray) -> np.ndarray:
        """Metric-specific query prep: cosine normalizes (zero → error)."""
        if self.metric == "cosine":
            from .metrics import normalize_rows
            return normalize_rows(vs, "query")
        return vs

    def query(self, v, k: int, nprobe: int,
              where=None) -> List[QueryResult]:
        return self.query_with_events(v, k, nprobe, _noop, where=where)

    def query_with_events(self, v, k: int, nprobe: int,
                          events: EventHandler,
                          where=None) -> List[QueryResult]:
        """Single-vector k-NN (``build.rs:307-340``).

        ``where`` (optional :class:`.filters.Filter`): only vectors whose
        attributes satisfy the predicate are returned (EXTENSION — masked
        on device before top-k, so results are the k nearest *matching*
        vectors in the probed partitions).
        """
        self._validate_query(k, nprobe)
        v = np.asarray(v, dtype=np.float32).reshape(1, -1)
        if v.shape[1] != self.vector_size:
            raise InvalidArgs(
                f"query vector size {v.shape[1]} != {self.vector_size}")
        v = self._prep_queries(v)
        mask = None if where is None else self._filter_mask(where)
        events(ev.StartingPartitionSelection())
        dists, rows, probed = self._device_state().query(
            v, k, nprobe, row_mask=mask)
        dists, rows, probed = dists[0], rows[0], probed[0]
        events(ev.FinishedPartitionSelection())
        for pi in probed:
            events(ev.StartingPartitionQuery(int(pi)))
            events(ev.FinishedPartitionQuery(int(pi)))
        events(ev.StartingResultSelection())
        results = self._to_results(dists, rows)
        events(ev.FinishedResultSelection())
        return results

    def query_batch(self, vs, k: int, nprobe: int,
                    rerank: Optional[int] = None,
                    where=None) -> List[List[QueryResult]]:
        """Batched k-NN — one fused device program for all queries.

        ``rerank``: optionally re-score the top ``rerank`` (> k) ADC
        candidates with EXACT distances against the retained original
        vectors and return the best ``k`` — a recall knob the reference
        doesn't have (its stored format drops originals; the in-memory
        database keeps residues, so reconstruction is a fused
        gather-add on device).

        ``where`` (optional :class:`.filters.Filter`): attribute filter,
        applied on device before top-k (and therefore before rerank —
        candidates are already all matching).
        """
        self._validate_query(k, nprobe)
        vs = as_vector_set(vs)
        if vs.shape[1] != self.vector_size:
            raise InvalidArgs(
                f"query vector size {vs.shape[1]} != {self.vector_size}")
        vs = self._prep_queries(vs)
        mask = None if where is None else self._filter_mask(where)
        if rerank is None:
            dists, rows, _ = self._device_state().query(
                vs, k, nprobe, row_mask=mask)
            return [self._to_results(dists[b], rows[b])
                    for b in range(len(vs))]
        if rerank < k:
            raise InvalidArgs(f"rerank ({rerank}) must be >= k ({k})")
        if self.residues is None:
            raise InvalidArgs("rerank requires retained residues")
        # Fused on the bucketed layout: the ADC query, the candidate
        # gather + exact re-score, and the final top-k run as ONE device
        # program, with no host round trip between the stages.
        dists, rows = self._device_state().query_rerank(
            vs, self._device_originals(), k=k, nprobe=nprobe,
            rerank=rerank, row_mask=mask)
        return [self._to_results(dists[b], rows[b]) for b in range(len(vs))]

    def query_range(self, v, radius: float, nprobe: int,
                    limit: Optional[int] = None,
                    where=None) -> List[QueryResult]:
        """Range search (EXTENSION): every vector in the probed
        partitions whose ranking key is ``<= radius``, ascending.

        The key is the same quantity :class:`QueryResult`
        ``squared_distance`` reports: squared L2 for ``l2``/``cosine``
        (cosine: ``2 − 2·cos``, so a similarity floor ``s`` is radius
        ``2 − 2s``), negated inner product for ``dot`` (an IP floor
        ``t`` is radius ``−t``). ``limit`` caps the result count (the
        nearest ``limit``); ``where`` filters on attributes. Like all
        IVF queries, only the ``nprobe`` nearest partitions are
        scanned.
        """
        self._validate_range(radius, nprobe)
        v = np.asarray(v, dtype=np.float32).reshape(1, -1)
        if v.shape[1] != self.vector_size:
            raise InvalidArgs(
                f"query vector size {v.shape[1]} != {self.vector_size}")
        v = self._prep_queries(v)
        mask = None if where is None else self._filter_mask(where)
        (rows, keys), = self._device_state().query_range(
            v, radius, nprobe, row_mask=mask)
        if limit is not None:
            rows, keys = rows[:limit], keys[:limit]
        local = self.local_indices
        return [
            QueryResult(
                partition_index=int(self.partition_indices[r]),
                vector_id=self.vector_ids[r],
                vector_index=int(local[r]),
                squared_distance=float(k),
            )
            for r, k in zip(rows.tolist(), keys.tolist())
        ]

    def _validate_range(self, radius, nprobe: int) -> None:
        from .stored import check_range_args
        check_range_args(radius, nprobe, self.num_partitions)

    def _device_originals(self):
        if self._dev_orig is None:
            self._dev_orig = jnp.asarray(
                self.residues
                + self.partition_centroids[self.partition_indices])
        return self._dev_orig

    def _validate_query(self, k: int, nprobe: int) -> None:
        if k <= 0:
            raise InvalidArgs(f"k must be positive: {k}")
        if nprobe <= 0:
            raise InvalidArgs(f"nprobe must be positive: {nprobe}")
        if nprobe > self.num_partitions:
            raise InvalidArgs(
                f"nprobe {nprobe} exceeds the number of partitions"
                f" {self.num_partitions}")

    def _to_results(self, dists: np.ndarray,
                    rows: np.ndarray) -> List[QueryResult]:
        local = self.local_indices
        out: List[QueryResult] = []
        for dist, row in zip(dists, rows):
            if not np.isfinite(dist):
                break  # fewer reachable vectors than k
            out.append(QueryResult(
                partition_index=int(self.partition_indices[row]),
                vector_id=self.vector_ids[row],
                vector_index=int(local[row]),
                squared_distance=float(dist),
            ))
        return out
