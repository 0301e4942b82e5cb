"""Flat (exact-search) database — reference roadmap item, implemented.

The reference lists "Flat database" as unreleased future work
(``README.md:74``). This module ships it device-native: raw vectors stored in
content-addressed chunks (same hashing/compression/attribute machinery as
the IVF-PQ format, :mod:`.serialize`), exact k-NN served by the chunked
device scan in :mod:`.ops.exact`, and — because chunks are independent
immutable artifacts — **appending vectors is an O(new-data) update**: write
the new chunks and a new root manifest, everything else is reused. That
makes this the first concrete cut of the reference's other roadmap item,
"Update database" (``README.md:73``).
"""

from __future__ import annotations

import uuid as _uuid
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .attributes import AttributeTable, AttributeValue, check_attribute_value
from .errors import InvalidArgs, InvalidData
from .io import FileSystem
from .protos import (
    PAttributesLog,
    PAttributeValue,
    PFlatChunk,
    PFlatDatabase,
    POperationSetAttribute,
    PUuid,
    PVectorSet,
)
from .serialize import PROTOBUF_EXTENSION
from .vector import as_vector_set

#: Vectors per stored chunk (f32 rows; 4096×1536 ≈ 25 MB uncompressed).
CHUNK_ROWS = 4096


def _make_uuids(n: int, rng: np.random.Generator) -> List[_uuid.UUID]:
    from .build import _make_uuids as impl
    return impl(n, rng)


@dataclass
class FlatQueryResult:
    """One exact k-NN result."""
    vector_id: _uuid.UUID
    vector_index: int           # global corpus row
    squared_distance: float

    _get_attr: Optional[callable] = field(default=None, repr=False)

    def get_attribute(self, key: str) -> Optional[AttributeValue]:
        if self._get_attr is None:
            raise InvalidArgs("result is not attached to a database")
        return self._get_attr(self.vector_id, key)


def _exact_query_dispatch(vs, dev, mask, mesh, *, k, n, metric):
    """Single-device vs SPMD exact top-k — the one dispatch both flat
    tiers share (a fix applied to the mesh path lands everywhere).
    ``metric`` is the DB metric; cosine ranks by the L2 key over unit
    vectors. Returns host ``(dists [B, k], rows [B, k])``."""
    import jax.numpy as jnp

    from .ops.exact import exact_topk

    kernel_metric = "dot" if metric == "dot" else "l2"
    if mesh is not None:
        from .parallel.exact import exact_sharded
        from .parallel.mesh import shard_mask
        if mask is not None:
            mask = shard_mask(mesh, mask)
        dists, rows = exact_sharded(jnp.asarray(vs), dev, mask, mesh=mesh,
                                    k=k, n=n, metric=kernel_metric)
    else:
        if mask is not None:
            mask = jnp.asarray(mask)
        dists, rows = exact_topk(jnp.asarray(vs), dev, mask, k=k,
                                 metric=kernel_metric)
    return np.asarray(dists), np.asarray(rows)


def _exact_keys_dispatch(v, dev, mesh, *, n, metric):
    """Single-device vs SPMD exact ranking keys (range search): host
    ``[B, n]`` (pads sliced off)."""
    import jax.numpy as jnp

    if mesh is not None:
        from .parallel.exact import exact_keys_sharded
        return np.asarray(exact_keys_sharded(
            jnp.asarray(v), dev, mesh=mesh, n=n,
            metric="dot" if metric == "dot" else "l2"))[:, :n]
    return np.asarray(_exact_keys(jnp.asarray(v), dev, metric))


class FlatDatabase:
    """In-memory exact-search database."""

    def __init__(self, vectors, vector_ids: Optional[List[_uuid.UUID]] = None,
                 seed: Optional[int] = None, metric: str = "l2") -> None:
        from .metrics import check_metric, normalize_rows

        self.metric = check_metric(metric)
        self._x = as_vector_set(vectors)
        if self.metric == "cosine":
            self._x = normalize_rows(self._x)
        rng = np.random.default_rng(seed)
        if vector_ids is None:
            vector_ids = _make_uuids(len(self._x), rng)
        if len(vector_ids) != len(self._x):
            raise InvalidArgs(
                f"{len(vector_ids)} IDs for {len(self._x)} vectors")
        self.vector_ids = list(vector_ids)
        self.attribute_table: AttributeTable = {}
        self._dev = None
        self._mesh = None
        self._rng = rng
        self._filter_cache = None

    def preload(self, mesh=None) -> None:
        """Pushes the corpus to the device — or, with a
        ``jax.sharding.Mesh``, row-shards it across the mesh so queries
        run the SPMD exact scan (:func:`..parallel.exact.exact_sharded`;
        local top-k per device, ``all_gather`` k-best merge). Corpora
        larger than one device's memory serve this way. Queries preload
        lazily on first use; call this explicitly to choose a mesh.
        A no-op when already resident under the same mesh."""
        import jax.numpy as jnp

        if self._dev is not None and mesh is self._mesh:
            return
        self._mesh = mesh
        if mesh is None:
            self._dev = jnp.asarray(self._x)
        else:
            from .parallel.exact import shard_flat
            self._dev = shard_flat(mesh, self._x)[0]

    # -- accessors -----------------------------------------------------------

    @property
    def vector_size(self) -> int:
        return self._x.shape[1]

    @property
    def num_vectors(self) -> int:
        return self._x.shape[0]

    @property
    def vectors(self) -> np.ndarray:
        return self._x

    # -- updates (roadmap "Update database": append-only) --------------------

    def append(self, vectors, vector_ids: Optional[List[_uuid.UUID]] = None,
               ) -> List[_uuid.UUID]:
        """Appends vectors; returns their IDs. O(new data) when re-saved."""
        new = as_vector_set(vectors, self.vector_size)
        if self.metric == "cosine":
            from .metrics import normalize_rows
            new = normalize_rows(new)
        if vector_ids is None:
            vector_ids = _make_uuids(len(new), self._rng)
        if len(vector_ids) != len(new):
            raise InvalidArgs(
                f"{len(vector_ids)} IDs for {len(new)} vectors")
        self._x = np.concatenate([self._x, new])
        self.vector_ids.extend(vector_ids)
        self._dev = None
        self._invalidate_filters()
        return list(vector_ids)

    def remove(self, vector_ids) -> int:
        """Removes vectors by ID; returns the number removed.

        Unknown IDs raise :class:`InvalidArgs`. Re-saving rewrites only
        the chunks that lost members (content addressing keeps the rest).
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
        self._x = self._x[keep]
        self.vector_ids = [vid for vid, kp in zip(self.vector_ids, keep)
                           if kp]
        for vid in doomed:
            self.attribute_table.pop(vid, None)
        self._dev = None
        self._invalidate_filters()
        return len(doomed)

    def _invalidate_filters(self) -> None:
        if self._filter_cache is not None:
            self._filter_cache.invalidate()

    def _filter_mask(self, where) -> np.ndarray:
        from .filters import ColumnCache, evaluate_mask
        if self._filter_cache is None:
            self._filter_cache = ColumnCache()
        return evaluate_mask(where, self.vector_ids, self.attribute_table,
                             self._filter_cache)

    # -- attributes -----------------------------------------------------------

    def set_attribute_at(self, i: int,
                         attribute: Tuple[str, AttributeValue]) -> None:
        if not 0 <= i < self.num_vectors:
            raise InvalidArgs(f"vector index out of bounds: {i}")
        key, value = attribute
        value = check_attribute_value(value)
        vid = self.vector_ids[i]
        self.attribute_table.setdefault(vid, {})[str(key)] = value
        self._invalidate_filters()

    def get_attribute(self, vector_id: _uuid.UUID,
                      key: str) -> Optional[AttributeValue]:
        try:
            attrs = self.attribute_table[vector_id]
        except KeyError:
            raise InvalidArgs(f"no such vector ID: {vector_id}") from None
        return attrs.get(key)

    # -- queries ---------------------------------------------------------------

    def query(self, v, k: int, where=None) -> List[FlatQueryResult]:
        return self.query_batch(np.asarray(v, np.float32)[None], k,
                                where=where)[0]

    def query_batch(self, vs, k: int,
                    where=None) -> List[List[FlatQueryResult]]:
        if k <= 0:
            raise InvalidArgs(f"k must be positive: {k}")
        vs = as_vector_set(vs, self.vector_size)
        if self.metric == "cosine":
            from .metrics import normalize_rows
            vs = normalize_rows(vs, "query")
        if self._dev is None:
            self.preload(self._mesh)
        mask = None if where is None else self._filter_mask(where)
        dists, rows = _exact_query_dispatch(
            vs, self._dev, mask, self._mesh, k=k, n=self.num_vectors,
            metric=self.metric)
        out = []
        for b in range(len(vs)):
            results = []
            for dist, row in zip(dists[b], rows[b]):
                if not np.isfinite(dist):
                    break
                results.append(FlatQueryResult(
                    vector_id=self.vector_ids[row],
                    vector_index=int(row),
                    squared_distance=float(dist),
                    _get_attr=self._get_attr_default_none,
                ))
            out.append(results)
        return out

    def query_range(self, v, radius: float, limit: Optional[int] = None,
                    where=None) -> List[FlatQueryResult]:
        """Exact range search (EXTENSION): every vector whose ranking
        key is ``<= radius``, ascending (key semantics per metric as in
        :meth:`..build.Database.query_range`). ``limit`` caps the
        result count."""
        import jax.numpy as jnp

        if not np.isfinite(radius):
            raise InvalidArgs(f"radius must be finite: {radius}")
        v = np.asarray(v, np.float32).reshape(1, -1)
        if v.shape[1] != self.vector_size:
            raise InvalidArgs(
                f"query vector size {v.shape[1]} != {self.vector_size}")
        if self.metric == "cosine":
            from .metrics import normalize_rows
            v = normalize_rows(v, "query")
        if self._dev is None:
            self.preload(self._mesh)
        mask = None if where is None else self._filter_mask(where)
        keys = _exact_keys_dispatch(v, self._dev, self._mesh,
                                    n=self.num_vectors,
                                    metric=self.metric)[0]
        if mask is not None:
            keys = np.where(mask, keys, np.inf)
        hit = np.nonzero(keys <= radius)[0]
        order = hit[np.argsort(keys[hit], kind="stable")]
        if limit is not None:
            order = order[:limit]
        return [
            FlatQueryResult(
                vector_id=self.vector_ids[r],
                vector_index=int(r),
                squared_distance=float(keys[r]),
                _get_attr=self._get_attr_default_none,
            )
            for r in order.tolist()
        ]

    def _get_attr_default_none(self, vid, key):
        return self.attribute_table.get(vid, {}).get(key)


def _exact_keys_impl(vs, xd, *, metric):
    import jax
    import jax.numpy as jnp

    if metric == "dot":
        return -jnp.matmul(vs, xd.T,
                           precision=jax.lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)
    from .ops.distance import sqdist
    return sqdist(vs, xd)


_exact_keys_jit = None


def _exact_keys(vs, xd, metric: str):
    """Exact ranking keys ``[B, N]`` on device (see metrics.py).

    The jit wrapper is module-cached — a per-call closure would retrace
    and recompile on EVERY query_range (measured 300× per-call overhead
    on CPU)."""
    global _exact_keys_jit
    if _exact_keys_jit is None:
        import functools

        import jax
        _exact_keys_jit = functools.partial(
            jax.jit, static_argnames=("metric",))(_exact_keys_impl)
    return _exact_keys_jit(vs, xd, metric="dot" if metric == "dot"
                           else "l2")


def _chunk_uuids(msg: PFlatChunk) -> List[_uuid.UUID]:
    """Chunk ids as ``uuid.UUID``s — straight from the bulk-decoded raw
    bytes when available (skips the intermediate PUuid objects)."""
    if msg.ids_raw is not None:
        return [_uuid.UUID(bytes=r.tobytes()) for r in msg.ids_raw]
    return [u.to_uuid() for u in msg.vector_ids]


def save_flat_database(db: FlatDatabase, fs: FileSystem) -> str:
    """Serializes into content-addressed chunks; returns the root hash."""
    chunk_ids: List[str] = []
    log_ids: List[str] = []
    names = sorted({k for attrs in db.attribute_table.values()
                    for k in attrs})
    name_index = {n: i for i, n in enumerate(names)}
    uuid_raw = (np.frombuffer(
        b"".join(u.bytes for u in db.vector_ids),
        np.uint8).reshape(-1, 16) if db.num_vectors else None)
    for start in range(0, max(db.num_vectors, 1), CHUNK_ROWS):
        rows = db.vectors[start:start + CHUNK_ROWS]
        ids = db.vector_ids[start:start + CHUNK_ROWS]
        if not len(rows):
            break
        raw = uuid_raw[start:start + CHUNK_ROWS]
        # Bulk-record encode needs every 64-bit half non-zero (proto3
        # omits zero scalars, changing the record length); fall back to
        # the per-message path for the ~2^-64-probability zero halves.
        if bool(raw[:, :8].any(1).all()) and bool(raw[:, 8:].any(1).all()):
            id_args = {"ids_raw": raw}
        else:
            id_args = {"vector_ids": [PUuid.from_uuid(v) for v in ids]}
        chunk = PFlatChunk(
            vector_size=db.vector_size,
            vectors=PVectorSet(vector_size=db.vector_size,
                               data=rows.reshape(-1)),
            **id_args,
        )
        f = fs.create_hashed_file("chunks", compress=True)
        f.write(chunk.encode())
        chunk_id = f.persist(PROTOBUF_EXTENSION)
        chunk_ids.append(chunk_id)

        log = PAttributesLog(partition_id=chunk_id)
        for vid in ids:
            for name, value in db.attribute_table.get(vid, {}).items():
                log.entries.append(POperationSetAttribute(
                    vector_id=PUuid.from_uuid(vid),
                    name_index=name_index[name],
                    value=PAttributeValue(value=value)))
        f = fs.create_hashed_file("attributes", compress=True)
        f.write(log.encode())
        log_ids.append(f.persist(PROTOBUF_EXTENSION))

    root = PFlatDatabase(
        vector_size=db.vector_size,
        num_vectors=db.num_vectors,
        chunk_ids=chunk_ids,
        attributes_log_ids=log_ids,
        attribute_names=names,
        metric="" if db.metric == "l2" else db.metric,
    )
    f = fs.create_hashed_file(compress=True)
    f.write(root.encode())
    return f.persist(PROTOBUF_EXTENSION)


def load_flat_database(fs: FileSystem, path: str) -> "StoredFlatDatabase":
    """Loads the root manifest only; chunks load lazily per query."""
    f = fs.open_hashed_file(path, compressed=True)
    payload = f.read()
    f.verify()
    root = PFlatDatabase.decode(payload)
    _validate_flat_root(root)
    return StoredFlatDatabase(fs=fs, root=root)


def _validate_flat_root(root: PFlatDatabase) -> None:
    from .metrics import VALID_METRICS

    if root.vector_size == 0:
        raise InvalidData("vector_size is zero")
    if len(root.chunk_ids) != len(root.attributes_log_ids):
        raise InvalidData("chunk/attributes-log count mismatch")
    if getattr(root, "metric", "") not in ("",) + VALID_METRICS:
        raise InvalidData(f"unknown metric: {root.metric!r}")


@dataclass
class StoredFlatDatabase:
    """Lazily-loaded stored flat database."""
    fs: FileSystem
    root: PFlatDatabase

    _chunks: List[Optional[tuple]] = field(default=None, repr=False)
    _attr_loaded: List[bool] = field(default=None, repr=False)
    _attribute_table: AttributeTable = field(default_factory=dict, repr=False)
    _dev: Optional[tuple] = field(default=None, repr=False)
    _mesh: Optional[object] = field(default=None, repr=False)
    _filter_cache: Optional[object] = field(default=None, repr=False)

    def __post_init__(self) -> None:
        self._chunks = [None] * len(self.root.chunk_ids)
        self._attr_loaded = [False] * len(self.root.chunk_ids)

    @property
    def vector_size(self) -> int:
        return self.root.vector_size

    @property
    def num_vectors(self) -> int:
        return self.root.num_vectors

    @property
    def attribute_names(self) -> List[str]:
        return self.root.attribute_names

    @property
    def metric(self) -> str:
        """Query metric (root extension field 21; "" = "l2")."""
        return getattr(self.root, "metric", "") or "l2"

    def _load_chunk(self, i: int) -> tuple:
        if self._chunks[i] is None:
            f = self.fs.open_hashed_file(
                f"chunks/{self.root.chunk_ids[i]}.{PROTOBUF_EXTENSION}",
                compressed=True)
            payload = f.read()
            f.verify()
            msg = PFlatChunk.decode(payload)
            if msg.vector_size != self.vector_size:
                raise InvalidData(
                    f"chunk vector_size {msg.vector_size} !="
                    f" {self.vector_size}")
            if msg.vectors is None:
                raise InvalidData("missing chunk vectors")
            x = msg.vectors.data.reshape(-1, self.vector_size)
            if len(x) != msg.ids_count:
                raise InvalidData("chunk id/vector count mismatch")
            self._chunks[i] = (x, _chunk_uuids(msg))
        return self._chunks[i]

    def _load_all_host(self):
        """All chunks concatenated host-side: ``([N, M] f32, ids)``.

        ``np.concatenate`` always copies, so the result never aliases the
        per-chunk caches."""
        parts = [self._load_chunk(i)
                 for i in range(len(self.root.chunk_ids))]
        x = (np.concatenate([p[0] for p in parts]) if parts
             else np.zeros((0, self.vector_size), np.float32))
        ids = [vid for p in parts for vid in p[1]]
        return x, ids

    def _load_all(self):
        import jax.numpy as jnp

        if self._dev is None:
            x, ids = self._load_all_host()
            if self._mesh is None:
                self._dev = (jnp.asarray(x), ids)
            else:
                from .parallel.exact import shard_flat
                self._dev = (shard_flat(self._mesh, x)[0], ids)
        return self._dev

    def preload(self, mesh=None) -> None:
        """Loads every chunk and pushes the corpus to the device — or,
        with a ``jax.sharding.Mesh``, row-shards it so queries run the
        SPMD exact scan (the flat analogue of
        :meth:`..stored.StoredDatabase.preload`). A no-op when already
        resident under the same mesh (no host re-concatenate or device
        re-transfer of a multi-GB corpus)."""
        if self._dev is not None and mesh is self._mesh:
            return
        self._mesh = mesh
        self._dev = None
        self._load_all()

    def query(self, v, k: int, where=None) -> List[FlatQueryResult]:
        return self.query_batch(np.asarray(v, np.float32)[None], k,
                                where=where)[0]

    def query_batch(self, vs, k: int,
                    where=None) -> List[List[FlatQueryResult]]:
        if k <= 0:
            raise InvalidArgs(f"k must be positive: {k}")
        vs = as_vector_set(vs, self.vector_size)
        if self.metric == "cosine":
            from .metrics import normalize_rows
            vs = normalize_rows(vs, "query")
        xd, ids = self._load_all()
        mask = None
        if where is not None:
            from .filters import ColumnCache, evaluate_mask
            self._ensure_attrs_loaded()
            if self._filter_cache is None:
                self._filter_cache = ColumnCache()
            mask = evaluate_mask(
                where, ids, self._attribute_table, self._filter_cache)
        dists, rows = _exact_query_dispatch(
            vs, xd, mask, self._mesh, k=k, n=self.num_vectors,
            metric=self.metric)
        out = []
        for b in range(len(vs)):
            results = []
            for dist, row in zip(dists[b], rows[b]):
                if not np.isfinite(dist):
                    break
                results.append(FlatQueryResult(
                    vector_id=ids[row],
                    vector_index=int(row),
                    squared_distance=float(dist),
                    _get_attr=self.get_attribute,
                ))
            out.append(results)
        return out

    def query_range(self, v, radius: float, limit: Optional[int] = None,
                    where=None) -> List[FlatQueryResult]:
        """Exact range search over the stored chunks (EXTENSION; key
        semantics per metric as in :meth:`FlatDatabase.query_range`)."""
        import jax.numpy as jnp

        if not np.isfinite(radius):
            raise InvalidArgs(f"radius must be finite: {radius}")
        v = np.asarray(v, np.float32).reshape(1, -1)
        if v.shape[1] != self.vector_size:
            raise InvalidArgs(
                f"query vector size {v.shape[1]} != {self.vector_size}")
        if self.metric == "cosine":
            from .metrics import normalize_rows
            v = normalize_rows(v, "query")
        xd, ids = self._load_all()
        mask = None
        if where is not None:
            from .filters import ColumnCache, evaluate_mask
            self._ensure_attrs_loaded()
            if self._filter_cache is None:
                self._filter_cache = ColumnCache()
            mask = evaluate_mask(where, ids, self._attribute_table,
                                 self._filter_cache)
        keys = _exact_keys_dispatch(v, xd, self._mesh,
                                    n=self.num_vectors,
                                    metric=self.metric)[0]
        if mask is not None:
            keys = np.where(mask, keys, np.inf)
        hit = np.nonzero(keys <= radius)[0]
        order = hit[np.argsort(keys[hit], kind="stable")]
        if limit is not None:
            order = order[:limit]
        return [
            FlatQueryResult(
                vector_id=ids[r],
                vector_index=int(r),
                squared_distance=float(keys[r]),
                _get_attr=self.get_attribute,
            )
            for r in order.tolist()
        ]

    def _ensure_attrs_loaded(self) -> None:
        from .stored import replay_attributes_log

        for i in range(len(self.root.chunk_ids)):
            if self._attr_loaded[i]:
                continue
            chunk = self._load_chunk(i)
            f = self.fs.open_hashed_file(
                f"attributes/{self.root.attributes_log_ids[i]}"
                f".{PROTOBUF_EXTENSION}",
                compressed=True)
            payload = f.read()
            f.verify()

            class _P:  # adapter: replay helper wants .vector_ids
                vector_ids = chunk[1]

            replay_attributes_log(
                payload, self.root.chunk_ids[i],
                self.root.attribute_names, _P, self._attribute_table, i)
            self._attr_loaded[i] = True

    def get_attribute(self, vector_id: _uuid.UUID,
                      key: str) -> Optional[AttributeValue]:
        self._ensure_attrs_loaded()
        try:
            attrs = self._attribute_table[vector_id]
        except KeyError:
            raise InvalidArgs(f"no such vector ID: {vector_id}") from None
        return attrs.get(key)

    def to_database(self) -> FlatDatabase:
        """Materializes the stored chunks into an in-memory
        :class:`FlatDatabase` — the flat tier's update story (mirror of
        :meth:`..stored.StoredDatabase.to_database`): load → mutate
        (:meth:`FlatDatabase.append` / :meth:`FlatDatabase.remove`) →
        ``save_flat_database`` back into the same store. Rows keep chunk
        order, so an append re-serializes the existing full chunks to
        byte-identical artifacts and the store skips their files."""
        x, ids = self._load_all_host()
        self._ensure_attrs_loaded()
        # Stored cosine rows are ALREADY unit vectors; constructing with
        # metric="cosine" would re-normalize (÷ ~0.99999994 in f32) and
        # flip low mantissa bits — breaking the byte-identical re-save
        # contract above. Build as-is, then tag the metric.
        db = FlatDatabase(x, ids)
        db.metric = self.metric
        db.attribute_table = {
            vid: dict(attrs)
            for vid, attrs in self._attribute_table.items()
        }
        return db


async def load_flat_database_async(fs, path: str) -> "AsyncStoredFlatDatabase":
    """Async flat loader (extension parity with :mod:`.asyncdb`)."""
    f = await fs.open_hashed_file(path, compressed=True)
    payload = await f.read()
    f.verify()
    root = PFlatDatabase.decode(payload)
    _validate_flat_root(root)
    return AsyncStoredFlatDatabase(fs=fs, root=root)


@dataclass
class AsyncStoredFlatDatabase:
    """Asyncio flat database: chunks load concurrently, queries run the
    same exact device scan. Attributes/filters mirror the sync tier:
    ``where=`` on :meth:`query` / :meth:`query_range`, awaitable
    :meth:`get_attribute` (logs load concurrently, once)."""
    fs: object
    root: PFlatDatabase

    _load_task: Optional[object] = field(default=None, repr=False)
    _attrs_task: Optional[object] = field(default=None, repr=False)
    _chunk_sizes: Optional[List[int]] = field(default=None, repr=False)
    _attribute_table: AttributeTable = field(default_factory=dict,
                                             repr=False)

    @property
    def metric(self) -> str:
        return getattr(self.root, "metric", "") or "l2"

    async def _load_all(self):
        import asyncio

        if self._load_task is None:
            async def load():
                async def one(i: int):
                    f = await self.fs.open_hashed_file(
                        f"chunks/{self.root.chunk_ids[i]}"
                        f".{PROTOBUF_EXTENSION}", compressed=True)
                    payload = await f.read()
                    f.verify()
                    msg = PFlatChunk.decode(payload)
                    if msg.vector_size != self.root.vector_size:
                        raise InvalidData("chunk vector_size mismatch")
                    if msg.vectors is None:
                        raise InvalidData("missing chunk vectors")
                    x = msg.vectors.data.reshape(-1, self.root.vector_size)
                    if len(x) != msg.ids_count:
                        raise InvalidData("chunk id/vector count mismatch")
                    return x, _chunk_uuids(msg)

                parts = await asyncio.gather(
                    *(one(i) for i in range(len(self.root.chunk_ids))))
                import jax.numpy as jnp
                x = (np.concatenate([p[0] for p in parts]) if parts else
                     np.zeros((0, self.root.vector_size), np.float32))
                ids = [vid for p in parts for vid in p[1]]
                # Per-chunk id counts for attribute-log replay: the wire
                # format does not pin a chunk size, so slices must come
                # from the ACTUAL chunks, never a CHUNK_ROWS constant.
                self._chunk_sizes = [len(p[0]) for p in parts]
                return jnp.asarray(x), ids

            self._load_task = asyncio.create_task(load())
        return await self._load_task

    async def _ensure_attrs(self) -> None:
        """Loads + replays ALL attribute logs, concurrently, once."""
        import asyncio

        from .stored import replay_attributes_log

        if self._attrs_task is None:
            async def load():
                _, all_ids = await self._load_all()

                async def one(i: int):
                    f = await self.fs.open_hashed_file(
                        f"attributes/{self.root.attributes_log_ids[i]}"
                        f".{PROTOBUF_EXTENSION}", compressed=True)
                    payload = await f.read()
                    f.verify()
                    return payload

                payloads = await asyncio.gather(
                    *(one(i) for i in range(len(self.root.chunk_ids))))
                pos = 0
                for i, payload in enumerate(payloads):
                    # Chunk i's id slice, from the loaded chunks' actual
                    # sizes (any writer's chunking is valid wire format).
                    lo, pos = pos, pos + self._chunk_sizes[i]

                    class _P:  # adapter: replay helper wants .vector_ids
                        vector_ids = all_ids[lo:pos]

                    replay_attributes_log(
                        payload, self.root.chunk_ids[i],
                        self.root.attribute_names, _P,
                        self._attribute_table, i)

            self._attrs_task = asyncio.create_task(load())
        await self._attrs_task

    async def get_attribute(self, vector_id: _uuid.UUID,
                            key: str) -> Optional[AttributeValue]:
        await self._ensure_attrs()
        try:
            attrs = self._attribute_table[vector_id]
        except KeyError:
            raise InvalidArgs(f"no such vector ID: {vector_id}") from None
        return attrs.get(key)

    async def _query_mask(self, where, ids):
        if where is None:
            return None
        from .filters import ColumnCache, evaluate_mask
        await self._ensure_attrs()
        return evaluate_mask(where, ids, self._attribute_table,
                             ColumnCache())

    def _prep_query(self, v) -> np.ndarray:
        v = np.asarray(v, np.float32).reshape(1, -1)
        if v.shape[1] != self.root.vector_size:
            raise InvalidArgs(
                f"query vector size {v.shape[1]} != {self.root.vector_size}")
        if self.metric == "cosine":
            from .metrics import normalize_rows
            v = normalize_rows(v, "query")
        return v

    async def query(self, v, k: int, where=None) -> List[FlatQueryResult]:
        import jax.numpy as jnp

        from .ops.exact import exact_topk

        if k <= 0:
            raise InvalidArgs(f"k must be positive: {k}")
        v = self._prep_query(v)
        xd, ids = await self._load_all()
        mask = await self._query_mask(where, ids)
        if mask is not None:
            mask = jnp.asarray(mask)
        dists, rows = exact_topk(
            jnp.asarray(v), xd, mask, k=k,
            metric="dot" if self.metric == "dot" else "l2")
        dists, rows = np.asarray(dists)[0], np.asarray(rows)[0]
        out = []
        for dist, row in zip(dists, rows):
            if not np.isfinite(dist):
                break
            out.append(FlatQueryResult(
                vector_id=ids[row], vector_index=int(row),
                squared_distance=float(dist)))
        return out

    async def query_range(self, v, radius: float,
                          limit: Optional[int] = None,
                          where=None) -> List[FlatQueryResult]:
        """Exact range search (EXTENSION; key semantics per metric as in
        :meth:`FlatDatabase.query_range`)."""
        import jax.numpy as jnp

        if not np.isfinite(radius):
            raise InvalidArgs(f"radius must be finite: {radius}")
        v = self._prep_query(v)
        xd, ids = await self._load_all()
        mask = await self._query_mask(where, ids)
        keys = np.asarray(_exact_keys(jnp.asarray(v), xd, self.metric))[0]
        if mask is not None:
            keys = np.where(mask, keys, np.inf)
        hit = np.nonzero(keys <= radius)[0]
        order = hit[np.argsort(keys[hit], kind="stable")]
        if limit is not None:
            order = order[:limit]
        return [
            FlatQueryResult(vector_id=ids[r], vector_index=int(r),
                            squared_distance=float(keys[r]))
            for r in order.tolist()
        ]
