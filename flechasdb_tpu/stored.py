"""Stored database: lazy loading + query.

Reference (``src/db/stored.rs``): loading a database reads *only* the root
manifest (~0.1 ms); partition centroids and codebooks load lazily on first
query, each partition's codes load only when a query probes it, and per-
partition attribute logs load only when an attribute is fetched. That is the
serverless design point — a stateless reader touches just ``nprobe``
partitions.

This port keeps the same laziness on the host (numpy) and adds a *warm
device path*: :meth:`StoredDatabase.preload` (or the first
:meth:`query_batch`) pushes the whole index to device memory, after which queries
run the fused masked-scan kernel from :mod:`.ops.adc`, batched.

Verification parity: root, codebooks and partitions are hash-verified on
load; partition centroids and attribute logs are *not* — reproducing the
reference's sync-path quirk (``db/stored.rs:190-195, 732-754`` skip
``verify()`` while ``:665, 789, 841`` call it). Pass ``verify_all=True`` for
the async path's stricter behaviour (``asyncdb/stored.rs:284-513``).
"""

from __future__ import annotations

import uuid as _uuid
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from . import _native
from . import events as ev
from .attributes import AttributeTable, AttributeValue
from .build import _local_indices
from .errors import InvalidArgs, InvalidData
from .events import EventHandler, _noop
from .io import FileSystem
from .protos import (
    PAttributesLog,
    PDatabase,
    PPartition,
    PVectorSet,
)

PROTOBUF_EXTENSION = "binpb"


class StoredPartition:
    """One loaded partition (``db/stored.rs:449-454``).

    UUID objects materialize lazily from the bulk-decoded ``[L, 16]``
    raw bytes: the cold query path touches only the k result IDs
    (:meth:`vector_id_at`), so it never pays the ~1 µs/object × L list
    build; attribute/filter/preload paths read :attr:`vector_ids` and
    materialize once.
    """

    __slots__ = ("codes", "_ids", "_ids_raw", "_id_cache")

    def __init__(self, codes: np.ndarray,
                 vector_ids: Optional[List[_uuid.UUID]] = None,
                 ids_raw: Optional[np.ndarray] = None) -> None:
        self.codes = codes              # [L, D] uint32
        self._ids = vector_ids
        self._ids_raw = ids_raw
        self._id_cache: dict = {}       # winners-only memo (repeat queries)

    @property
    def vector_ids(self) -> List[_uuid.UUID]:
        if self._ids is None:
            self._ids = [_uuid.UUID(bytes=r.tobytes())
                         for r in self._ids_raw]
        return self._ids

    def vector_id_at(self, i: int) -> _uuid.UUID:
        if self._ids is not None:
            return self._ids[i]
        u = self._id_cache.get(i)
        if u is None:
            u = _uuid.UUID(bytes=self._ids_raw[i].tobytes())
            self._id_cache[i] = u
        return u


def validate_root(root: PDatabase) -> PDatabase:
    """Root-manifest invariants (``db/stored.rs:659-722``)."""
    if root.vector_size == 0:
        raise InvalidData("vector_size is zero")
    if root.num_divisions == 0:
        raise InvalidData("num_divisions is zero")
    if root.num_partitions == 0:
        raise InvalidData("num_partitions is zero")
    if root.num_codes == 0:
        raise InvalidData("num_codes is zero")
    if root.vector_size % root.num_divisions != 0:
        raise InvalidData(
            f"vector_size {root.vector_size} is not multiple of"
            f" num_divisions {root.num_divisions}")
    if root.num_partitions != len(root.partition_ids):
        raise InvalidData(
            f"num_partitions {root.num_partitions} and partition_ids.len()"
            f" {len(root.partition_ids)} do not match")
    if root.num_divisions != len(root.codebook_ids):
        raise InvalidData(
            f"num_divisions {root.num_divisions} and codebook_ids.len()"
            f" {len(root.codebook_ids)} do not match")
    from .metrics import VALID_METRICS
    if getattr(root, "metric", "") not in ("",) + VALID_METRICS:
        raise InvalidData(f"unknown metric: {root.metric!r}")
    return root


def decode_vector_set(payload: bytes, expected_size: int,
                      expected_count: int, what: str) -> np.ndarray:
    """Decodes + shape-checks a ``VectorSet`` file
    (``db/stored.rs:729-806``)."""
    vs = PVectorSet.decode(payload)
    if vs.vector_size != expected_size:
        raise InvalidData(
            f"{what}: vector_size is inconsistent: expected"
            f" {expected_size} but got {vs.vector_size}")
    if vs.vector_size == 0 or len(vs.data) != expected_count * vs.vector_size:
        raise InvalidData(
            f"{what}: expected {expected_count} vectors but got"
            f" {len(vs.data) // max(vs.vector_size, 1)}")
    return vs.data.reshape(expected_count, expected_size)


def decode_partition(payload: bytes, vector_size: int,
                     num_divisions: int) -> StoredPartition:
    """Decodes + validates a partition file (``db/stored.rs:824-881``)."""
    msg = PPartition.decode(payload)
    if msg.encoded_vectors is None:
        raise InvalidData("missing encoded vectors")
    if msg.vector_size != vector_size:
        raise InvalidData(
            f"vector_size {vector_size} and partition.vector_size"
            f" {msg.vector_size} do not match")
    if msg.num_divisions != num_divisions:
        raise InvalidData(
            f"num_divisions {num_divisions} and partition.num_divisions"
            f" {msg.num_divisions} do not match")
    evs = msg.encoded_vectors
    if evs.vector_size != num_divisions or \
            len(evs.data) % max(evs.vector_size, 1):
        raise InvalidData("encoded vector shape mismatch")
    codes = evs.data.reshape(-1, num_divisions)
    if len(codes) != msg.ids_count:
        raise InvalidData(
            f"number of vector IDs is inconsistent: expected"
            f" {len(codes)} but got {msg.ids_count}")
    if msg.ids_raw is not None:
        return StoredPartition(codes=codes, ids_raw=msg.ids_raw)
    return StoredPartition(
        codes=codes,
        vector_ids=[u.to_uuid() for u in msg.vector_ids],
    )


def vid_in_partition(partition: StoredPartition, vector_id: _uuid.UUID,
                     raw: "np.ndarray | None" = None) -> bool:
    """Membership of ``vector_id`` among a partition's members — one
    vectorized raw-bytes compare when the bulk-decoded id records are
    available (shared by the sync and async lazy-attribute lookups)."""
    if partition._ids_raw is not None:
        if raw is None:
            raw = np.frombuffer(vector_id.bytes, np.uint8)
        return bool((partition._ids_raw == raw).all(axis=1).any())
    return vector_id in partition.vector_ids


def replay_attributes_log(payload: bytes, expected_partition_id: str,
                          names: List[str], partition: StoredPartition,
                          table: AttributeTable,
                          partition_index: int,
                          populate_defaults: bool = True) -> None:
    """Replays one partition's set-op log into ``table``, last write wins
    (``db/stored.rs:185-260``)."""
    log = PAttributesLog.decode(payload)
    if log.partition_id != expected_partition_id:
        raise InvalidData(
            f"inconsistent partition IDs: {log.partition_id} vs"
            f" {expected_partition_id}")
    for i, entry in enumerate(log.entries):
        if entry.name_index >= len(names):
            raise InvalidData(
                f"attribute name index out of bounds: {entry.name_index}")
        if entry.vector_id is None:
            raise InvalidData(
                f"attributes log[{partition_index}, {i}]: missing vector ID")
        if entry.value is None or entry.value.value is None:
            raise InvalidData(
                f"attributes log[{partition_index}, {i}]: missing value")
        vid = entry.vector_id.to_uuid()
        table.setdefault(vid, {})[names[entry.name_index]] = entry.value.value
    # Vectors without attributes default to an empty map so lookups on
    # existing vectors never fail (db/stored.rs:251-257). The sync
    # stored DB opts out (round 5): materializing ~L UUID objects + dict
    # inserts per partition dominated the COLD attribute fetch (~1.5 ms
    # per 1k-member partition, 5-partition fetch ≈ 7 ms); it answers
    # attribute-less lookups with a raw-bytes membership probe instead
    # (`StoredDatabase._vid_known`) — observable behavior identical.
    if populate_defaults:
        for vid in partition.vector_ids:
            table.setdefault(vid, {})


def _query_io_threads() -> bool:
    """Whether per-query artifact loads should use a thread pool.

    The pool wins only when loads can actually overlap — multiple cores
    (the native inflate+hash releases the GIL but is CPU-bound) or
    IO-blocking reads. Measured on a 1-vCPU host: pool 9.9 ms vs serial
    7.1 ms for the 5-partition cold query — pool setup + GIL churn is
    pure overhead there, so single-core hosts stay serial. (The bulk
    ``preload`` pool is unaffected: page-cache-cold reads block on IO,
    where threads overlap even on one core.)
    """
    import os
    return (os.cpu_count() or 1) > 1


def topk_stable(dists: np.ndarray, k: int) -> np.ndarray:
    """Indices of the ``k`` smallest, ascending, stable tie-break —
    exactly ``np.argsort(dists, kind="stable")[:k]``, without paying a
    full mergesort (the reference keeps a k-bounded n-best heap instead
    of sorting, ``nbest.rs``). Native ``partial_sort`` when the IO
    runtime is loaded; a partition + boundary-tie repair in numpy
    otherwise."""
    n = len(dists)
    if k <= 0:
        return np.empty(0, np.intp)
    if k >= n:
        return np.argsort(dists, kind="stable")
    if dists.dtype == np.float32:        # f64 must not round through f32
        got = _native.topk_f32(np.ascontiguousarray(dists), k)
        if got is not None:
            return got
    kth = np.partition(dists, k - 1)[k - 1]
    lt = np.nonzero(dists < kth)[0]              # ascending by construction
    eq = np.nonzero(dists == kth)[0][:k - len(lt)]
    cand = np.concatenate([lt, eq])
    return cand[np.argsort(dists[cand], kind="stable")]


def adc_tables(centroid_deltas: np.ndarray, codebooks: np.ndarray,
               rotation: np.ndarray | None = None,
               codebook_sq_norms: np.ndarray | None = None,
               codebooks_t: np.ndarray | None = None,
               ) -> tuple[np.ndarray, np.ndarray]:
    """ADC lookup tables for ``n`` query residuals at once.

    ``centroid_deltas: [n, M]`` → ``(tables [n, D, C] f32 C-contiguous,
    qnorms [n])`` where ``tables[j] + qnorms[j]`` is partition j's
    per-row ``‖local−c‖²`` (``db/stored.rs:549-575``), built as
    ``‖c‖² − 2·c@local`` + the per-query scalar ``‖local‖²`` — one BLAS
    batched matvec instead of the subtract-square broadcast, whose
    ``[D, C, m]`` temporary measured 0.5 ms of the reference-headline
    warm budget. With an OPQ ``rotation`` the *residuals* rotate before
    table construction (never the raw query). All ``n`` cross
    terms come from ONE batched GEMM ``[D, n, m] @ [D, m, C]`` — the
    query path builds its nprobe tables in a single BLAS call instead of
    nprobe matvecs (they depend only on the probed centroids, never on
    partition contents, so they batch before any partition loads). The
    orientation matters: with C on the output's minor axis this measured
    130 us vs 237 us for ``[D, C, m] @ [D, m, n]`` at the headline shape.
    ``codebooks_t`` is the cached ``[D, m, C]`` contiguous transpose
    (``StoredDatabase._codebooks_t``); recomputed here when absent.
    """
    d, c, m_sub = codebooks.shape
    locs = centroid_deltas
    if rotation is not None:
        locs = locs @ rotation
    qnorms = np.einsum("nm,nm->n", locs, locs).astype(np.float32)
    locd = locs.reshape(len(locs), d, m_sub)
    if codebook_sq_norms is None:
        codebook_sq_norms = np.einsum("dcm,dcm->dc", codebooks, codebooks)
    if codebooks_t is None:
        codebooks_t = np.ascontiguousarray(codebooks.transpose(0, 2, 1))
    loct = np.ascontiguousarray(locd.transpose(1, 0, 2))       # [D, n, m]
    cross = np.matmul(loct, codebooks_t)                       # [D, n, C]
    tables = np.ascontiguousarray(
        (codebook_sq_norms[:, None, :] - 2.0 * cross).transpose(1, 0, 2),
        dtype=np.float32)
    return tables, qnorms


def check_range_args(radius, nprobe: int, num_partitions: int) -> None:
    """Shared ``query_range`` argument validation (in-memory, stored
    sync, stored async all enforce the same rules)."""
    if not np.isfinite(radius):
        raise InvalidArgs(f"radius must be finite: {radius}")
    if nprobe <= 0:
        raise InvalidArgs(f"nprobe must be positive: {nprobe}")
    if nprobe > num_partitions:
        raise InvalidArgs(
            f"nprobe {nprobe} exceeds the number of partitions"
            f" {num_partitions}")


def merge_range_candidates(cand, limit, clamp: bool, make_result) -> list:
    """Shared ``query_range`` tail: ascending (key, probe-order) sort,
    optional cap, f32-cancellation clamp (L2/cosine only — dot keys are
    legitimately negative), result materialization via ``make_result(key,
    j, part, vi)``. ``cand`` holds ``(key, probe_order, part, vi)``."""
    cand.sort(key=lambda t: (t[0], t[1]))
    if limit is not None:
        cand = cand[:limit]
    return [
        make_result(0.0 if (clamp and key < 0.0) else key, j, part, vi)
        for key, j, part, vi in cand
    ]


def adc_tables_dot(v: np.ndarray, cent_scores: np.ndarray,
                   codebooks: np.ndarray,
                   rotation: np.ndarray | None = None,
                   codebooks_t: np.ndarray | None = None,
                   ) -> tuple[np.ndarray, np.ndarray]:
    """MIPS ADC tables, host path (see :mod:`.metrics` and
    :func:`.ops.adc._dot_tables` for the device analogue).

    ``v [M]``, ``cent_scores [n] = −⟨v, c_j⟩`` for the probed partitions
    (a gather from the coarse scores the probe selection already
    computed) → ``(tables [n, D, C] f32 C-contiguous, qnorms [n]
    zeros)`` with the per-partition scalar ``−⟨v, c_j⟩/D`` folded into
    every table entry, so the same native gather-accumulate / k-best
    heap (:func:`adc_scan_topk`) ranks by ``−⟨v, x̂⟩``. The
    query·codebook product is partition-independent — ONE ``[D, 1, m] @
    [D, m, C]`` GEMM serves all nprobe tables.
    """
    d, c, m_sub = codebooks.shape
    vq = v if rotation is None else v @ rotation
    if codebooks_t is None:
        codebooks_t = np.ascontiguousarray(codebooks.transpose(0, 2, 1))
    cross = np.matmul(vq.reshape(d, 1, m_sub), codebooks_t)    # [D, 1, C]
    scal = np.asarray(cent_scores, np.float32) / np.float32(d)  # [n]
    tables = np.ascontiguousarray(
        scal[:, None, None] - cross.transpose(1, 0, 2), dtype=np.float32)
    return tables, np.zeros(len(scal), np.float32)


def adc_dists(table: np.ndarray, qnorm: float,
              codes: np.ndarray) -> np.ndarray:
    """All-row distances against one precomputed ``[D, C]`` table (see
    :func:`adc_tables`); native gather-accumulate when available. For
    callers that re-rank after masking (filters) and would waste a
    top-k over unmasked distances."""
    dists = _native.adc_sum(table, codes)
    if dists is None:
        d = table.shape[0]
        dists = table[np.arange(d)[None, :], codes].sum(1)
    dists += qnorm
    return dists


def adc_scan_with_table(table: np.ndarray, qnorm: float, codes: np.ndarray,
                        k: int) -> tuple[np.ndarray, np.ndarray]:
    """Row scan against one precomputed ``[D, C]`` table (see
    :func:`adc_tables`); native gather-accumulate when available."""
    dists = adc_dists(table, qnorm, codes)
    order = topk_stable(dists, k)
    return order, dists


def adc_scan_topk(table: np.ndarray, qnorm: float, codes: np.ndarray,
                  k: int) -> tuple[np.ndarray, np.ndarray]:
    """k-best rows against one precomputed table: ``(order, dists[order])``.

    One fused native pass (gather-accumulate into a k-bounded heap,
    ``fio_adc_topk``) when available — the unfiltered warm query's inner
    loop, where the two-step scan's second ctypes crossing and the L-sized
    distance array are pure overhead. Falls back to the two-step path
    (numpy or native) identically."""
    got = _native.adc_topk(table, qnorm, codes, k)
    if got is not None:
        return got
    order, dists = adc_scan_with_table(table, qnorm, codes, k)
    return order, dists[order]


@dataclass
class StoredQueryResult:
    """k-NN result from a stored database (``db/stored.rs:600-612``)."""
    db: "StoredDatabase"
    partition_index: int
    vector_id: _uuid.UUID
    vector_index: int               # local index within the partition
    squared_distance: float

    def get_attribute(self, key: str) -> Optional[AttributeValue]:
        """Lazily loads this partition's attribute log
        (``db/stored.rs:625-638``)."""
        return self.db._get_attribute_in_partition(
            self.partition_index, self.vector_id, key)


def load_database(fs: FileSystem, path: str) -> "StoredDatabase":
    """Loads the root manifest only (``db/stored.rs:659-722``)."""
    f = fs.open_hashed_file(path, compressed=True)
    payload = f.read()
    f.verify()
    root = validate_root(PDatabase.decode(payload))
    return StoredDatabase(fs=fs, root=root)


@dataclass
class StoredDatabase:
    """Lazily-loaded stored database (``db/stored.rs:41-57``)."""
    fs: FileSystem
    root: PDatabase
    verify_all: bool = False

    _partitions: List[Optional[StoredPartition]] = field(default=None,
                                                         repr=False)
    _partition_centroids: Optional[np.ndarray] = field(default=None,
                                                       repr=False)
    _codebooks: Optional[np.ndarray] = field(default=None, repr=False)
    _attr_loaded: List[bool] = field(default=None, repr=False)
    # Shared from birth (never check-then-create: two threads racing the
    # creation would each replay into a dict the other's assignment then
    # discards, silently losing a partition's attributes — the async
    # mirror was born with default_factory=dict for the same reason).
    _attribute_table: AttributeTable = field(default_factory=dict,
                                             repr=False)
    _attrs_all_loaded: bool = field(default=False, repr=False)
    _rotation: Optional[np.ndarray] = field(default=None, repr=False)
    _rotation_loaded: bool = field(default=False, repr=False)
    _codebook_sq_norms: Optional[np.ndarray] = field(default=None,
                                                     repr=False)
    _codebooks_t: Optional[np.ndarray] = field(default=None, repr=False)
    _centroid_sq_norms: Optional[np.ndarray] = field(default=None,
                                                     repr=False)
    _dev: Optional[tuple] = field(default=None, repr=False)
    _filter_cache: Optional[object] = field(default=None, repr=False)

    def __post_init__(self) -> None:
        self._partitions = [None] * self.num_partitions
        self._attr_loaded = [False] * self.num_partitions

    # -- accessors (db/stored.rs:63-101) ------------------------------------

    @property
    def vector_size(self) -> int:
        return self.root.vector_size

    @property
    def num_partitions(self) -> int:
        return self.root.num_partitions

    @property
    def num_divisions(self) -> int:
        return self.root.num_divisions

    @property
    def num_codes(self) -> int:
        return self.root.num_codes

    @property
    def subvector_size(self) -> int:
        return self.vector_size // self.num_divisions

    @property
    def attribute_names(self) -> List[str]:
        return self.root.attribute_names

    @property
    def metric(self) -> str:
        """Query metric (extension root field 21; "" = "l2")."""
        return getattr(self.root, "metric", "") or "l2"

    def get_partition_id(self, index: int) -> Optional[str]:
        ids = self.root.partition_ids
        return ids[index] if 0 <= index < len(ids) else None

    def get_codebook_id(self, index: int) -> Optional[str]:
        ids = self.root.codebook_ids
        return ids[index] if 0 <= index < len(ids) else None

    # -- lazy loaders (db/stored.rs:641-882) ---------------------------------

    def _load_partition_centroids(self) -> np.ndarray:
        """Uncompressed; sync path skips verify (``db/stored.rs:729-755``)."""
        if self._partition_centroids is None:
            f = self.fs.open_hashed_file(
                f"partitions/{self.root.partition_centroids_id}"
                f".{PROTOBUF_EXTENSION}")
            payload = f.read(need_hash=self.verify_all)
            if self.verify_all:
                f.verify()
            cents = decode_vector_set(
                payload, self.vector_size, self.num_partitions,
                "partition centroids")
            # Publish the guard field LAST: a concurrent query that sees
            # non-None centroids must also see the derived norms (GIL
            # bytecode ordering makes this sufficient).
            self._centroid_sq_norms = np.einsum("pm,pm->p", cents, cents)
            self._partition_centroids = cents
        return self._partition_centroids

    def _load_codebooks(self) -> np.ndarray:
        """All D codebooks, verified (``db/stored.rs:769-806``).

        The D files load concurrently on a short-lived thread pool — the
        native inflate+hash pass and the file reads release the GIL, so
        the first query stops serializing D open→inflate→decode
        round-trips (the reference loads them sequentially,
        ``db/stored.rs:772-780``; its async path exists to overlap
        exactly this)."""
        if self._codebooks is None:
            def load_one(di: int) -> np.ndarray:
                f = self.fs.open_hashed_file(
                    f"codebooks/{self.root.codebook_ids[di]}"
                    f".{PROTOBUF_EXTENSION}")
                payload = f.read()
                f.verify()
                return decode_vector_set(
                    payload, self.subvector_size, self.num_codes,
                    f"codebook[{di}]")

            d = self.num_divisions
            if d > 1 and _query_io_threads():
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(min(d, 16)) as ex:
                    cbs = list(ex.map(load_one, range(d)))
            else:
                cbs = [load_one(di) for di in range(d)]
            stacked = np.stack(cbs)             # [D, C, m]
            # Derived caches BEFORE the guard field (see centroids above).
            self._codebook_sq_norms = np.einsum(
                "dcm,dcm->dc", stacked, stacked)
            self._codebooks_t = np.ascontiguousarray(
                stacked.transpose(0, 2, 1))     # [D, m, C] for GEMM
            self._codebooks = stacked
        return self._codebooks

    def _load_rotation(self) -> Optional[np.ndarray]:
        """OPQ rotation (extension field 20), verified, loaded once."""
        if not self._rotation_loaded:
            rid = getattr(self.root, "rotation_id", "")
            if rid:
                f = self.fs.open_hashed_file(
                    f"rotations/{rid}.{PROTOBUF_EXTENSION}")
                payload = f.read()
                f.verify()
                self._rotation = decode_vector_set(
                    payload, self.vector_size, self.vector_size,
                    "rotation")
            self._rotation_loaded = True
        return self._rotation

    def get_partition(self, index: int) -> StoredPartition:
        """Lazily loads a partition (``db/stored.rs:269-293, 824-881``)."""
        if not 0 <= index < self.num_partitions:
            raise InvalidArgs(f"partition index out of bounds: {index}")
        if self._partitions[index] is None:
            f = self.fs.open_hashed_file(
                f"partitions/{self.root.partition_ids[index]}"
                f".{PROTOBUF_EXTENSION}",
                compressed=True)
            payload = f.read()
            f.verify()
            self._partitions[index] = decode_partition(
                payload, self.vector_size, self.num_divisions)
        return self._partitions[index]

    # -- attributes (db/stored.rs:118-260) -----------------------------------

    def get_attribute(self, vector_id: _uuid.UUID,
                      key: str) -> Optional[AttributeValue]:
        """Loads *all* attribute logs on first use (``db/stored.rs:118-131``);
        prefer :meth:`StoredQueryResult.get_attribute` after a query."""
        if not self._attrs_all_loaded:
            for pi in range(self.num_partitions):
                self._load_attributes_log(pi)
            self._attrs_all_loaded = True
        return self._get_attribute_loaded(vector_id, key)

    def _get_attribute_in_partition(self, partition_index: int,
                                    vector_id: _uuid.UUID,
                                    key: str) -> Optional[AttributeValue]:
        self._load_attributes_log(partition_index)
        return self._get_attribute_loaded(vector_id, key)

    def _get_attribute_loaded(self, vector_id: _uuid.UUID,
                              key: str) -> Optional[AttributeValue]:
        table = self._attribute_table
        try:
            attrs = table[vector_id]
        except KeyError:
            # Attribute-less vectors are not pre-populated (see
            # replay_attributes_log populate_defaults); an existing
            # vector without attributes answers None, an unknown id
            # raises — same contract as the eager-defaults form.
            if self._vid_known(vector_id):
                # Memoize the known-empty answer: repeated lookups on
                # the same attribute-less vector must stay O(1) dict
                # hits, not re-pay the membership scan.
                table[vector_id] = {}
                return None
            raise InvalidArgs(f"no such vector ID: {vector_id}") from None
        return attrs.get(key)

    def _vid_known(self, vector_id: _uuid.UUID) -> bool:
        """Membership of ``vector_id`` in any partition whose attribute
        log is loaded (the same visibility the eager empty-map defaults
        gave): one vectorized raw-bytes probe per loaded partition."""
        raw = np.frombuffer(vector_id.bytes, np.uint8)
        return any(
            vid_in_partition(self.get_partition(pi), vector_id, raw)
            for pi, loaded in enumerate(self._attr_loaded) if loaded)

    def _load_attributes_log(self, partition_index: int) -> None:
        """Replays one partition's set-op log, last write wins
        (``db/stored.rs:185-260``); sync path skips verify (quirk)."""
        if self._attr_loaded[partition_index]:
            return
        partition = self.get_partition(partition_index)
        f = self.fs.open_hashed_file(
            f"attributes/{self.root.attributes_log_ids[partition_index]}"
            f".{PROTOBUF_EXTENSION}",
            compressed=True)
        payload = f.read(need_hash=self.verify_all)
        if self.verify_all:
            f.verify()
        replay_attributes_log(
            payload, self.root.partition_ids[partition_index],
            self.root.attribute_names, partition, self._attribute_table,
            partition_index, populate_defaults=False)
        self._attr_loaded[partition_index] = True

    # -- attribute filtering (EXTENSION, see filters.py) ----------------------

    def _partition_filter_mask(self, where, partition_index: int,
                               partition: StoredPartition) -> np.ndarray:
        """Row mask over one partition's local rows (lazy: loads only that
        partition's attribute log)."""
        from .filters import ColumnCache, evaluate_mask
        self._load_attributes_log(partition_index)
        return evaluate_mask(where, partition.vector_ids,
                             self._attribute_table, ColumnCache())

    def _global_filter_mask(self, where) -> np.ndarray:
        """Row mask over the preloaded corpus (loads every attribute log
        once; cached columns make repeated filters vectorized numpy)."""
        from .filters import ColumnCache, evaluate_mask
        for pi in range(self.num_partitions):
            self._load_attributes_log(pi)
        if self._filter_cache is None:
            self._filter_cache = ColumnCache()
        _, _, _, vector_ids = self._dev
        return evaluate_mask(where, vector_ids,
                             self._attribute_table,
                             self._filter_cache)

    # -- queries (db/stored.rs:305-442, 534-598) -----------------------------

    def query(self, v, k: int, nprobe: int,
              where=None) -> List[StoredQueryResult]:
        return self.query_with_events(v, k, nprobe, _noop, where=where)

    def query_with_events(self, v, k: int, nprobe: int,
                          events: EventHandler,
                          where=None) -> List[StoredQueryResult]:
        """Single-vector k-NN with lazy partition loads.

        Cold queries run the per-partition ADC scan on the host (they are
        I/O-bound); once the database has been :meth:`preload`-ed, queries
        run the fused device kernel instead.

        ``where`` (optional :class:`.filters.Filter`) restricts results to
        vectors whose attributes match; on the cold path only the probed
        partitions' attribute logs are loaded (lazy, like everything else
        here).
        """
        self._validate_query(k, nprobe)
        v = np.asarray(v, np.float32).reshape(-1)
        if v.shape[0] != self.vector_size:
            raise InvalidArgs(
                f"query vector size {v.shape[0]} != {self.vector_size}")
        if self.metric == "cosine":
            from .metrics import normalize_rows
            v = normalize_rows(v[None], "query")[0]

        if self._dev is not None:
            mask = None if where is None else self._global_filter_mask(where)
            return self._query_device(v[None], k, nprobe, events,
                                      row_mask=mask)[0]

        events(ev.StartingQueryInitialization())
        centroids = self._load_partition_centroids()
        codebooks = self._load_codebooks()
        rotation = self._load_rotation()
        events(ev.FinishedQueryInitialization())

        events(ev.StartingPartitionSelection())
        if self.metric == "dot":
            # MIPS coarse key: −⟨v, c⟩ (see metrics.py).
            coarse = -(centroids @ v)
        else:
            # Ranking-only: ‖v−c‖² = ‖c‖² − 2·c·v + const(v); the constant
            # cannot change the argsort, and ‖c‖² is cached at centroid
            # load.
            coarse = self._centroid_sq_norms - 2.0 * (centroids @ v)
        probed = topk_stable(coarse, nprobe)
        events(ev.FinishedPartitionSelection())

        # Per-partition k-best as (dists, rows) arrays; result objects (and
        # their UUIDs) materialize only for the final k winners — the old
        # per-candidate construction built nprobe*k objects to discard all
        # but k (db/stored.rs builds lazily for the same reason,
        # stored.rs:576-612).
        # All nprobe ADC tables in one batched GEMM (they depend only on
        # the probed centroids, db/stored.rs:549-575).
        if self.metric == "dot":
            tables, qnorms = adc_tables_dot(
                v, coarse[probed], codebooks, rotation,
                self._codebooks_t)
        else:
            tables, qnorms = adc_tables(
                v[None] - centroids[probed], codebooks, rotation,
                self._codebook_sq_norms, self._codebooks_t)

        # Prefetch missing probed partitions concurrently: inflate+hash
        # releases the GIL, so a cold query stops paying nprobe serial
        # round-trips (probed indices are distinct — no duplicated loads;
        # the scan loop below then hits the cache).
        missing = [int(pi) for pi in probed
                   if self._partitions[int(pi)] is None]
        if len(missing) > 1 and _query_io_threads():
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(min(len(missing), 16)) as ex:
                list(ex.map(self.get_partition, missing))
        # Hot path (no filter, no observer): every probed partition is
        # already loadable, so all nprobe scans collapse into ONE native
        # call — per-partition ctypes crossings and the python loop body
        # were ~40% of the warm query after the scans themselves went
        # native. The event-handler path below keeps per-partition events
        # interleaved with the scans they describe.
        if where is None and events is _noop:
            parts = [self.get_partition(int(pi)) for pi in probed]
            got = _native.adc_topk_batch(
                tables, qnorms, [pt.codes for pt in parts], k)
            if got is not None:
                idxb, distb, cntb = got
                if int(cntb.min()) == k:
                    # All partitions returned full rows: the merge runs on
                    # the [n, k] blocks directly (no concat bookkeeping).
                    alld = distb.reshape(-1)
                    results = []
                    for gi in topk_stable(alld, k).tolist():
                        sq = float(alld[gi])
                        if sq == np.inf:    # overflow rows: warm-path parity
                            break           # (ascending: the rest are inf too)
                        pj, o = divmod(gi, k)
                        vi = int(idxb[pj, o])
                        results.append(StoredQueryResult(
                            db=self,
                            partition_index=int(probed[pj]),
                            vector_id=parts[pj].vector_id_at(vi),
                            vector_index=vi,
                            # the ranking-only ‖c‖²−2·c·r+‖r‖² expansion can
                            # go ~-1e-6 on exact matches (f32 cancellation);
                            # the device path clamps, so does the result.
                            # Dot keys are legitimately negative (−⟨q,x⟩).
                            squared_distance=sq if (
                                sq >= 0.0 or self.metric == "dot") else 0.0,
                        ))
                    return results
                sel_d = [distb[j, :int(cntb[j])] for j in range(len(parts))]
                sel_vi = [idxb[j, :int(cntb[j])] for j in range(len(parts))]
                sel_pi = [int(pi) for pi in probed]
                sel_part = parts
                return self._merge_selected(sel_d, sel_vi, sel_pi,
                                            sel_part, k, events)

        sel_d: List[np.ndarray] = []
        sel_vi: List[np.ndarray] = []
        sel_pi: List[int] = []
        sel_part: List[StoredPartition] = []
        for j, pi in enumerate(probed):
            events(ev.StartingPartitionQuery(int(pi)))
            part = self.get_partition(int(pi))
            # Table gather-sum; keep k best per partition
            # (db/stored.rs:576-595)
            if where is None:
                order, dsel = adc_scan_topk(
                    tables[j], float(qnorms[j]), part.codes, k)
            else:
                dists = adc_dists(tables[j], float(qnorms[j]), part.codes)
                mask = self._partition_filter_mask(where, int(pi), part)
                dists = np.where(mask, dists, np.inf)
                order = topk_stable(dists, k)
                dsel = dists[order]
                fin = np.isfinite(dsel)          # drop masked-out sentinels
                if not fin.all():
                    order, dsel = order[fin], dsel[fin]
            sel_d.append(dsel)
            sel_vi.append(order)
            sel_pi.append(int(pi))
            sel_part.append(part)
            events(ev.FinishedPartitionQuery(int(pi)))

        return self._merge_selected(sel_d, sel_vi, sel_pi, sel_part, k,
                                    events)

    def query_range(self, v, radius: float, nprobe: int,
                    limit: Optional[int] = None,
                    where=None) -> List[StoredQueryResult]:
        """Range search (EXTENSION — see :meth:`..build.Database
        .query_range` for the key/radius semantics per metric).

        Runs on the host path with the same lazy loads as a cold
        :meth:`query` — only the ``nprobe`` probed partitions' files are
        touched (and after :meth:`preload` every partition is already
        cached), so range queries stay serverless-cheap.
        """
        check_range_args(radius, nprobe, self.num_partitions)
        v = np.asarray(v, np.float32).reshape(-1)
        if v.shape[0] != self.vector_size:
            raise InvalidArgs(
                f"query vector size {v.shape[0]} != {self.vector_size}")
        if self.metric == "cosine":
            from .metrics import normalize_rows
            v = normalize_rows(v[None], "query")[0]

        centroids = self._load_partition_centroids()
        codebooks = self._load_codebooks()
        rotation = self._load_rotation()
        if self.metric == "dot":
            coarse = -(centroids @ v)
        else:
            coarse = self._centroid_sq_norms - 2.0 * (centroids @ v)
        probed = topk_stable(coarse, nprobe)
        if self.metric == "dot":
            tables, qnorms = adc_tables_dot(
                v, coarse[probed], codebooks, rotation, self._codebooks_t)
        else:
            tables, qnorms = adc_tables(
                v[None] - centroids[probed], codebooks, rotation,
                self._codebook_sq_norms, self._codebooks_t)

        cand: List[tuple] = []      # (key, probe_order, part, vi)
        for j, pi in enumerate(probed):
            part = self.get_partition(int(pi))
            dists = adc_dists(tables[j], float(qnorms[j]), part.codes)
            if where is not None:
                mask = self._partition_filter_mask(where, int(pi), part)
                dists = np.where(mask, dists, np.inf)
            hit = np.nonzero(dists <= radius)[0]
            for vi in hit:
                cand.append((float(dists[vi]), j, part, int(vi)))
        return merge_range_candidates(
            cand, limit, self.metric != "dot",
            lambda key, j, part, vi: StoredQueryResult(
                db=self,
                partition_index=int(probed[j]),
                vector_id=part.vector_id_at(vi),
                vector_index=vi,
                squared_distance=key,
            ))

    def _merge_selected(self, sel_d, sel_vi, sel_pi, sel_part, k: int,
                        events: EventHandler) -> List[StoredQueryResult]:
        """Stable top-k over the probe-ordered concatenation of the
        per-partition k-bests == a stable sort of the full candidate list
        (``db/stored.rs:378-387`` n-best merge)."""
        events(ev.StartingResultSelection())
        alld = np.concatenate(sel_d) if sel_d else np.empty(0, np.float32)
        bounds = np.cumsum([0] + [len(x) for x in sel_d])
        gis = topk_stable(alld, k)
        pjs = np.searchsorted(bounds, gis, side="right") - 1
        results = []
        for gi, pj in zip(gis.tolist(), pjs.tolist()):
            sq = float(alld[gi])
            if sq == np.inf:        # overflow rows: warm-path parity
                break               # (selection is ascending)
            vi = int(sel_vi[pj][gi - bounds[pj]])
            results.append(StoredQueryResult(
                db=self,
                partition_index=sel_pi[pj],
                vector_id=sel_part[pj].vector_id_at(vi),
                vector_index=vi,
                # clamp f32-cancellation negatives (see the fast path);
                # dot keys are legitimately negative
                squared_distance=sq if (sq >= 0.0 or self.metric == "dot")
                else 0.0,
            ))
        events(ev.FinishedResultSelection())
        return results

    def _load_all_partitions(self, events: EventHandler = _noop,
                             max_workers: Optional[int] = None
                             ) -> List[StoredPartition]:
        """Loads every partition, missing ones concurrently on a thread
        pool — the native inflate+hash pass releases the GIL, so
        open→inflate→decode round-trips overlap instead of serializing P
        times through Python. ``events`` receives ``Starting/
        FinishedPartitionLoad`` from worker threads; pass a thread-safe
        handler."""
        import os
        from concurrent.futures import ThreadPoolExecutor

        missing = [pi for pi in range(self.num_partitions)
                   if self._partitions[pi] is None]

        def load_one(pi: int) -> None:
            events(ev.StartingPartitionLoad(pi))
            self.get_partition(pi)
            events(ev.FinishedPartitionLoad(pi))

        workers = max_workers or min(32, max(4, (os.cpu_count() or 8)))
        if len(missing) > 1 and workers > 1:
            with ThreadPoolExecutor(workers) as ex:
                list(ex.map(load_one, missing))
        else:
            for pi in missing:
                load_one(pi)
        return [self.get_partition(pi) for pi in range(self.num_partitions)]

    def to_database(self, events: EventHandler = _noop,
                    max_workers: Optional[int] = None) -> "Database":
        """Materializes the stored tree into an in-memory :class:`Database`.

        The update story for stored databases (the reference leaves
        "Update database" open, ``README.md:73``): ``load_database`` →
        ``to_database()`` → :meth:`Database.add_vectors` /
        :meth:`Database.remove_vectors` → ``save_database`` back into the
        same store. Rows materialize partition-by-partition in stored
        order, so an untouched partition re-serializes to byte-identical
        artifacts — same content hash, same file — and the re-save writes
        only touched partitions plus the root manifest (the content store
        skips persisting files that already exist).

        Residues are not part of the wire format (``database.proto``), so
        the materialized database cannot :meth:`Database.reconstruct` or
        exact-rerank; everything else (query, filters, attributes,
        updates, re-save) works.
        """
        from .build import Database

        centroids = self._load_partition_centroids()
        codebooks = self._load_codebooks()
        rotation = self._load_rotation()
        parts = self._load_all_partitions(events, max_workers)
        for pi in range(self.num_partitions):
            self._load_attributes_log(pi)
        self._attrs_all_loaded = True
        codes = np.concatenate([p.codes for p in parts]) \
            if parts else np.zeros((0, self.num_divisions), np.uint32)
        pidx = np.concatenate([
            np.full(len(p.codes), pi, np.int32)
            for pi, p in enumerate(parts)
        ]) if parts else np.zeros((0,), np.int32)
        vector_ids = [vid for p in parts for vid in p.vector_ids]
        # Only vectors the log actually touched: a natively built Database
        # holds table entries solely for vectors that saw set_attribute_at
        # (get_attribute on others raises InvalidArgs, db/build.rs:228-245)
        # — the materialized object reproduces the ORIGINAL builder
        # semantics, not the stored tier's seeded-empty-map lookups. There
        # is no attribute-delete op, so empty ⇔ never touched.
        table: AttributeTable = {
            vid: dict(attrs)
            for vid, attrs in self._attribute_table.items() if attrs
        }
        return Database(
            vector_size=self.vector_size,
            num_partitions=self.num_partitions,
            num_divisions=self.num_divisions,
            num_clusters=self.num_codes,
            vector_ids=vector_ids,
            partition_centroids=np.array(centroids),
            partition_indices=pidx,
            codebooks=np.array(codebooks),
            codes=codes.astype(np.uint32, copy=False),
            residues=None,
            rotation=None if rotation is None else np.array(rotation),
            metric=self.metric,
            attribute_table=table,
        )

    def preload(self, mesh=None, events: EventHandler = _noop,
                max_workers: Optional[int] = None) -> None:
        """Loads every partition and pushes the index to the device(s).

        After this, :meth:`query` and :meth:`query_batch` run the fused
        device kernels (:mod:`.serving`) — the warm serving mode. With a
        ``jax.sharding.Mesh``, the index shards across its devices and
        queries run an SPMD program: by default the PRUNED layout —
        buckets shard on the partition axis, each device scans only the
        probed buckets it owns (:mod:`.parallel.bucketed`) — falling back
        to the masked full scan (:mod:`.parallel.query`) under partition
        skew; either way local top-k per device then an ``all_gather``
        k-best merge across the mesh.

        Partition files load CONCURRENTLY on a thread pool — the native
        inflate+hash pass releases the GIL, so open→inflate→decode
        round-trips overlap instead of serializing P times through Python
        (the reference's async path exists to overlap exactly this,
        ``asyncdb/stored/query.rs:248-254``). ``events`` receives
        ``Starting/FinishedPartitionLoad`` from worker threads; pass a
        thread-safe handler.
        """
        from .serving import DeviceIndex, ShardedIndex

        centroids = self._load_partition_centroids()
        codebooks = self._load_codebooks()
        parts = self._load_all_partitions(events, max_workers)
        codes = np.concatenate([p.codes for p in parts]) \
            if parts else np.zeros((0, self.num_divisions), np.uint32)
        pidx = np.concatenate([
            np.full(len(p.codes), pi, np.int32)
            for pi, p in enumerate(parts)
        ])
        vector_ids = [vid for p in parts for vid in p.vector_ids]
        local = _local_indices(pidx, self.num_partitions)
        rotation = self._load_rotation()
        cls = DeviceIndex if mesh is None else \
            (lambda *a, **kw: ShardedIndex(*a, **kw, mesh=mesh))
        index = cls(centroids, codebooks, codes.astype(np.int32), pidx,
                    rotation=rotation, metric=self.metric)
        self._dev = (index, pidx, local, vector_ids)

    def query_batch(self, vs, k: int, nprobe: int,
                    where=None) -> List[List[StoredQueryResult]]:
        """Batched k-NN on device (loads everything on first use).

        ``where`` (optional :class:`.filters.Filter`): attribute filter,
        masked on device before top-k."""
        self._validate_query(k, nprobe)
        if self._dev is None:
            self.preload()
        vs = np.asarray(vs, np.float32)
        if vs.ndim == 1:
            vs = vs[None]
        if vs.shape[1] != self.vector_size:
            raise InvalidArgs(
                f"query vector size {vs.shape[1]} != {self.vector_size}")
        if self.metric == "cosine":
            from .metrics import normalize_rows
            vs = normalize_rows(vs, "query")
        mask = None if where is None else self._global_filter_mask(where)
        return self._query_device(vs, k, nprobe, _noop, row_mask=mask)

    def _query_device(self, vs: np.ndarray, k: int, nprobe: int,
                      events: EventHandler,
                      row_mask=None) -> List[List[StoredQueryResult]]:
        index, pidx, local, vector_ids = self._dev
        events(ev.StartingPartitionSelection())
        dists, rows, _ = index.query(vs, k, nprobe, row_mask=row_mask)
        events(ev.FinishedPartitionSelection())
        events(ev.StartingResultSelection())
        # Result materialization is host-bound at serving batch sizes
        # (B·k python objects); gather everything with vectorized numpy
        # indexing + one .tolist() pass instead of per-element scalar
        # conversions. Distances ascend per row, so finite results form a
        # prefix; +inf tail rows hold index 0 and are never touched.
        counts = np.isfinite(dists).sum(axis=1).tolist()
        p_rows = pidx[rows].tolist()
        l_rows = local[rows].tolist()
        d_rows = dists.tolist()
        r_rows = rows.tolist()
        out: List[List[StoredQueryResult]] = []
        for b in range(len(vs)):
            pb, lb, db_, rb = p_rows[b], l_rows[b], d_rows[b], r_rows[b]
            out.append([
                StoredQueryResult(
                    db=self,
                    partition_index=pb[i],
                    vector_id=vector_ids[rb[i]],
                    vector_index=lb[i],
                    squared_distance=db_[i],
                )
                for i in range(counts[b])
            ])
        events(ev.FinishedResultSelection())
        return out

    def _validate_query(self, k: int, nprobe: int) -> None:
        if k <= 0:
            raise InvalidArgs(f"k must be positive: {k}")
        if nprobe <= 0:
            raise InvalidArgs(f"nprobe must be positive: {nprobe}")
        if nprobe > self.num_partitions:
            raise InvalidArgs(
                f"nprobe {nprobe} exceeds the number of partitions"
                f" {self.num_partitions}")
