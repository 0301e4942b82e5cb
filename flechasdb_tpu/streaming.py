"""Streaming build — corpora larger than device memory (and host RAM).

The reference builds strictly in RAM: ``db/build.rs:78-129`` holds the
corpus, the residual copy, and the divided views simultaneously, so its
build size is bounded by host memory. The device pipeline here
(:mod:`.parallel.build`) lifts that to device memory — but a corpus that
does not fit in device memory could previously not be built at all.

:class:`StreamingDatabaseBuilder` decouples build size from both budgets:

* **training** runs on bounded uniform row samples — centroid/codebook
  quality saturates at a few hundred rows per cluster (the same rationale
  as :data:`.parallel.build.COARSE_TRAIN_CAP` / ``PQ_TRAIN_CAP``, which
  FAISS shares), so the samples are capped by rows *and* bytes;
* **encoding** — the only full-corpus work: nearest-partition assignment
  plus PQ residual codes — streams fixed-size row chunks host→device
  through ONE compiled program (:func:`.ops.encode.encode`; the final
  partial chunk is zero-padded so no reshape ever recompiles).

The corpus source only needs ``.shape`` and row slicing (``src[lo:hi]``),
which ``np.ndarray``, ``np.memmap``, h5py/zarr datasets all provide — so
a corpus can live on disk, larger than host RAM, and never materialize.
Host-resident build state is O(N) only in ids + codes
(``16 + 4·D`` bytes/vector), never in raw vectors.

The result is a regular in-memory :class:`.build.Database` (with
``residues=None`` — reconstruction/rerank need retained originals and
raise ``InvalidArgs``, as documented there): savable with
:func:`.serialize.save_database`, servable warm via ``query_batch``, and
wire-compatible with the reference like any other build.
"""

from __future__ import annotations

from typing import Optional, TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:                                # annotation-only import
    from .build import Database

from . import events as ev
from .errors import InvalidArgs
from .events import EventHandler, _noop
from .parallel.build import COARSE_TRAIN_CAP, PQ_TRAIN_CAP

#: Byte budget for each training sample (raw f32 rows). Bounds host + device
#: use of the training phase independently of the corpus row count — at
#: M=1536 this is ~175k rows, at M=96 the row caps bind first.
SAMPLE_BYTES = 1 << 30

#: Byte budget for one streamed encode chunk. Each chunk pays one
#: host→device round trip, so chunks are large; the device-side transient is the chunk itself plus a
#: ``[chunk', D, C]`` distance tile inside :func:`.ops.encode.encode`
#: (itself internally streamed by ``assign_chunked``).
CHUNK_BYTES = 256 << 20


def _gather_rows(source, rows: np.ndarray, m: int) -> np.ndarray:
    """Fetches ``source[rows]`` (rows sorted unique) as an f32 array.

    Fancy row indexing is tried first (``np.memmap`` reads only the
    touched pages; h5py accepts sorted unique index lists); sources that
    support only contiguous slices fall back to grouped range reads.
    """
    try:
        return np.asarray(source[rows], dtype=np.float32)
    except (TypeError, IndexError, NotImplementedError):
        out = np.empty((len(rows), m), np.float32)
        i = 0
        while i < len(rows):
            # Longest run of consecutive indices → one contiguous read.
            j = i + 1
            while j < len(rows) and rows[j] == rows[j - 1] + 1:
                j += 1
            out[i:j] = source[int(rows[i]):int(rows[j - 1]) + 1]
            i = j
        return out


class StreamingDatabaseBuilder:
    """Fluent builder over an out-of-core corpus source.

    Mirrors :class:`.build.DatabaseBuilder` (defaults P=10, D=8, C=16,
    ``build.rs:44-52``) but takes a *source* — anything with ``.shape``
    and row slicing — instead of an in-memory array, and bounds device
    and host memory regardless of corpus size (see module docstring).

    >>> corpus = np.lib.format.open_memmap("vectors.npy")   # 100 GB
    >>> db = (StreamingDatabaseBuilder(corpus)
    ...       .with_partitions(4096).with_divisions(8)
    ...       .with_clusters(256).with_seed(7).build())
    """

    def __init__(self, source) -> None:
        shape = getattr(source, "shape", None)
        if shape is None:
            source = np.asarray(source, np.float32)
            shape = source.shape
        if len(shape) != 2 or shape[0] == 0 or shape[1] == 0:
            raise InvalidArgs(
                f"streamed build needs a non-empty [N, M] source, "
                f"got shape {tuple(shape)}")
        self._source = source
        self._n, self._m = int(shape[0]), int(shape[1])
        self._num_partitions = 10
        self._num_divisions = 8
        self._num_clusters = 16
        self._seed: Optional[int] = None
        self._impl: Optional[str] = None
        self._opq_iters = 0
        self._coarse_cap = COARSE_TRAIN_CAP
        self._pq_cap = PQ_TRAIN_CAP
        self._sample_bytes = SAMPLE_BYTES
        self._chunk_rows: Optional[int] = None
        self._mesh = None
        self._metric = "l2"

    def with_partitions(self, p: int) -> "StreamingDatabaseBuilder":
        if p <= 0:
            raise InvalidArgs(f"num_partitions must be positive: {p}")
        self._num_partitions = p
        return self

    def with_divisions(self, d: int) -> "StreamingDatabaseBuilder":
        if d <= 0:
            raise InvalidArgs(f"num_divisions must be positive: {d}")
        self._num_divisions = d
        return self

    def with_clusters(self, c: int) -> "StreamingDatabaseBuilder":
        if c <= 0:
            raise InvalidArgs(f"num_clusters must be positive: {c}")
        self._num_clusters = c
        return self

    def with_fast_math(self, on: bool = True) -> "StreamingDatabaseBuilder":
        """``Precision.DEFAULT`` assignment matmuls in training (see
        :meth:`.build.DatabaseBuilder.with_fast_math`)."""
        self._impl = "_fast" if on else None
        return self

    def with_seed(self, seed: int) -> "StreamingDatabaseBuilder":
        """Fixes sampling, clustering, and UUID assignment (same caveats
        as :meth:`.build.DatabaseBuilder.with_seed`)."""
        self._seed = seed
        return self

    def with_opq(self, iters: int = 8) -> "StreamingDatabaseBuilder":
        """OPQ rotation, trained on the residual sample (extension; see
        :meth:`.build.DatabaseBuilder.with_opq`)."""
        if iters <= 0:
            raise InvalidArgs(f"opq iters must be positive: {iters}")
        self._opq_iters = iters
        return self

    def with_metric(self, metric: str) -> "StreamingDatabaseBuilder":
        """Query metric (extension; see :meth:`.build.DatabaseBuilder
        .with_metric` and :mod:`.metrics`). Cosine normalizes every row
        as it streams (training sample and encode chunks alike); zero
        rows raise :class:`InvalidArgs` when they stream past."""
        from .metrics import check_metric
        self._metric = check_metric(metric)
        return self

    def with_training_caps(self, *, coarse_cap: Optional[int] = None,
                           pq_cap: Optional[int] = None,
                           sample_bytes: Optional[int] = None,
                           ) -> "StreamingDatabaseBuilder":
        """Overrides the training-sample budgets (rows and bytes)."""
        if coarse_cap is not None:
            if coarse_cap <= 0:
                raise InvalidArgs(f"coarse_cap must be positive: {coarse_cap}")
            self._coarse_cap = coarse_cap
        if pq_cap is not None:
            if pq_cap <= 0:
                raise InvalidArgs(f"pq_cap must be positive: {pq_cap}")
            self._pq_cap = pq_cap
        if sample_bytes is not None:
            if sample_bytes <= 0:
                raise InvalidArgs(
                    f"sample_bytes must be positive: {sample_bytes}")
            self._sample_bytes = sample_bytes
        return self

    def with_chunk_rows(self, rows: int) -> "StreamingDatabaseBuilder":
        """Overrides the streamed-encode chunk size (rows per program)."""
        if rows <= 0:
            raise InvalidArgs(f"chunk_rows must be positive: {rows}")
        self._chunk_rows = rows
        return self

    def with_mesh(self, mesh) -> "StreamingDatabaseBuilder":
        """Shards the streamed encode over a device mesh (extension).

        Training stays single-device — it runs on bounded samples. The
        full-corpus pass (partition assignment + PQ encoding, the only
        N-sized work) splits row-wise: each chunk lands sharded across
        the mesh and the one compiled encode program runs SPMD (GSPMD
        partitions it — the program is pure XLA, so unlike the Pallas
        build kernels no ``shard_map`` is needed). Per-row math is
        unchanged (the reduction axes stay on-device), so codes are
        bit-identical to the unsharded encode.
        """
        self._mesh = mesh
        return self

    def build_with_events(self, events: EventHandler) -> "Database":
        """Name-parity alias for :meth:`build` (``build.rs:73-78``)."""
        return self.build(events)

    def build(self, events: EventHandler = _noop) -> "Database":
        """Runs the sampled-training + streamed-encoding pipeline.

        Same phase structure (and events) as the in-memory builder
        (``build.rs:78-129``); the corpus is read once for the training
        sample gather and once for the encode stream.
        """
        import jax
        import jax.numpy as jnp

        from .build import Database, _make_uuids
        from .ops import kmeans
        from .ops.distance import assign_chunked
        from .ops.encode import encode

        n, m = self._n, self._m
        p, d, c = (self._num_partitions, self._num_divisions,
                   self._num_clusters)
        if n < p:
            raise InvalidArgs(f"vs has fewer vectors than k: {n} < {p}")
        if n < c:
            raise InvalidArgs(f"vs has fewer vectors than k: {n} < {c}")
        if m % d != 0:
            raise InvalidArgs(f"vector size ({m}) is not divisible by {d}")

        # Row- and byte-capped sample sizes, floored at the cluster counts
        # (a budget below k rows cannot train k centroids, so the floor
        # silently wins over an over-tight cap).
        byte_rows = max(1, self._sample_bytes // (4 * m))
        s_coarse = min(n, max(self._coarse_cap, p), max(byte_rows, p))
        s_pq = min(n, max(self._pq_cap, c), max(byte_rows, c))

        seed = (np.random.SeedSequence().entropy if self._seed is None
                else self._seed)
        rng = np.random.default_rng(seed)
        key = jax.random.key(int(np.uint32(rng.integers(0, 2 ** 32))))
        k_coarse, k_pq = jax.random.split(key)

        events(ev.StartingIdAssignment())
        vector_ids = _make_uuids(n, rng)
        events(ev.FinishedIdAssignment())

        # ---- training sample (one gather serves both phases: the rows
        # are uniform draws, exactly what each phase would sample alone).
        # The draw must be WITHOUT replacement: a with-replacement draw
        # collapsed through unique can come up short of the cluster-count
        # floor when the budget lands at exactly p or c rows, and k-means
        # would then reject a perfectly valid corpus.
        s_max = max(s_coarse, s_pq)
        if s_max >= n:
            rows = np.arange(n, dtype=np.int64)
        elif 2 * s_max >= n:
            # Dense sample: a full permutation costs <= 2x the sample.
            rows = np.sort(rng.permutation(n)[:s_max].astype(np.int64))
        else:
            # Sparse sample of a (possibly huge out-of-core) corpus:
            # draw-and-dedupe, topping up the collision shortfall — at
            # s_max < n/2 the expected shortfall shrinks geometrically.
            rows = np.unique(rng.integers(0, n, size=s_max, dtype=np.int64))
            for _ in range(16):
                if len(rows) >= s_max:
                    break
                extra = rng.integers(0, n, size=2 * (s_max - len(rows)),
                                     dtype=np.int64)
                rows = np.unique(np.concatenate([rows, extra]))
            else:  # pragma: no cover - probabilistically unreachable
                rows = np.sort(rng.permutation(n)[:s_max].astype(np.int64))
            if len(rows) > s_max:   # trim overshoot; keep sorted for IO
                rows = np.sort(rows[rng.permutation(len(rows))[:s_max]])
        sample = _gather_rows(self._source, rows, m)
        if self._metric == "cosine":
            from .metrics import normalize_rows
            sample = normalize_rows(sample)
        s_have = len(sample)

        cluster_events = ((lambda e: events(ev.ClusterEvent(e)))
                          if events is not _noop else _noop)

        events(ev.StartingPartitioning())
        coarse_rows = min(s_have, s_coarse)
        sub = (sample if coarse_rows == s_have
               else sample[rng.permutation(s_have)[:coarse_rows]])
        sample_dev = jnp.asarray(sub)
        if events is _noop:
            coarse = kmeans.fit(sample_dev[None], p, k_coarse,
                                impl=self._impl)
        else:
            coarse = kmeans.fit_with_events(sample_dev[None], p, k_coarse,
                                            cluster_events,
                                            impl=self._impl)
        cents = coarse.centroids[0]                       # [P, M] device
        events(ev.FinishedPartitioning())

        events(ev.StartingSubvectorDivision())
        pq_rows = min(s_have, s_pq)
        if pq_rows == coarse_rows:
            pq_dev = sample_dev
        else:
            sel = (slice(None) if pq_rows == s_have
                   else rng.permutation(s_have)[:pq_rows])
            pq_dev = jnp.asarray(sample[sel])
        pidx_s, _ = assign_chunked(pq_dev[None], cents[None], k=p)
        residues_s = pq_dev - jnp.take(cents, pidx_s[0], axis=0)
        events(ev.FinishedSubvectorDivision())

        for i in range(d):
            events(ev.StartingQuantization(i))
        rotation = None
        if self._opq_iters:
            from .ops.opq import fit_opq
            opq = fit_opq(residues_s, d, c, k_pq, iters=self._opq_iters)
            rotation, pq = np.asarray(opq.rotation), opq.pq
        else:
            divided = residues_s.reshape(
                pq_rows, d, m // d).transpose(1, 0, 2)
            if events is _noop:
                pq = kmeans.fit(divided, c, k_pq, impl=self._impl)
            else:
                pq = kmeans.fit_with_events(divided, c, k_pq, cluster_events,
                                            impl=self._impl)
            del divided
        for i in range(d):
            events(ev.FinishedQuantization(i))

        # Training is done: drop the sample (host, up to SAMPLE_BYTES) and
        # its device copies before the long streamed-encode phase, which
        # otherwise runs with ~2x the memory it needs.
        del sample, sub, sample_dev, pq_dev, residues_s, pidx_s

        # ---- streamed encode: the only full-corpus pass. Fixed chunk
        # shape (final chunk zero-padded) keeps it ONE compiled program.
        chunk = self._chunk_rows or max(1, CHUNK_BYTES // (4 * m))
        chunk = min(chunk, n)
        rot_dev = None if rotation is None else jnp.asarray(rotation)
        enc_cents, enc_books, enc_rot = cents, pq.centroids, rot_dev
        put = jnp.asarray
        if self._mesh is not None:        # sharded encode (see with_mesh)
            from jax.sharding import NamedSharding, PartitionSpec
            from .parallel.mesh import AXIS
            mesh = self._mesh
            n_dev = int(mesh.devices.size)
            chunk = -(-chunk // n_dev) * n_dev   # shards divide evenly
            rows_s = NamedSharding(mesh, PartitionSpec(AXIS, None))
            rep = NamedSharding(mesh, PartitionSpec())
            enc_cents = jax.device_put(cents, rep)
            enc_books = jax.device_put(pq.centroids, rep)
            enc_rot = (None if rot_dev is None
                       else jax.device_put(rot_dev, rep))

            def put(xb):                  # noqa: E306 - chunk placer
                return jax.device_put(xb, rows_s)
        pidx = np.empty(n, np.int32)
        codes = np.empty((n, d), np.uint32)
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            xb = np.asarray(self._source[lo:hi], dtype=np.float32)
            if self._metric == "cosine":
                from .metrics import normalize_rows
                xb = normalize_rows(xb)
            if hi - lo < chunk:                # pad-row codes are discarded
                xb = np.pad(xb, ((0, chunk - (hi - lo)), (0, 0)))
            pi, co = encode(put(xb), enc_cents, enc_books, enc_rot)
            pidx[lo:hi] = np.asarray(pi)[:hi - lo]
            codes[lo:hi] = np.asarray(co)[:hi - lo]

        return Database(
            vector_size=m,
            num_partitions=p,
            num_divisions=d,
            num_clusters=c,
            vector_ids=vector_ids,
            partition_centroids=np.asarray(cents),
            partition_indices=pidx,
            codebooks=np.asarray(pq.centroids),
            codes=codes,
            residues=None,
            rotation=rotation,
            metric=self._metric,
        )
