"""Acceptance test: load a database tree written by an INDEPENDENT writer.

Message-by-message checks leave the wire-compat claim open: no *whole
database tree* written by an independent implementation would be loaded. No Rust toolchain exists in
this image, so this module plays the reference's role with a writer built
from nothing but the protoc-generated codec + stdlib (zlib/hashlib/base64) —
it exercises NONE of flechasdb_tpu's encode path, mirroring
``src/db/build/proto.rs:25-63`` (artifact set + compression choices) and
``src/io.rs:90-129`` (zlib level 6, URL-safe-base64 SHA-256-of-stored-bytes
naming).

Both directions are covered:
* a tree written by the independent writer loads and queries through the
  sync, async, and device (preload) stored paths, with results matching a
  NumPy ADC oracle computed straight from the raw arrays;
* every artifact of a flechasdb-tpu-written tree parses through the protoc
  codec with stdlib decompression and hash verification.
"""

import asyncio
import base64
import hashlib
import importlib.util
import shutil
import subprocess
import sys
import uuid
import zlib
from pathlib import Path

import numpy as np
import pytest

FIXTURES = Path(__file__).parent / "fixtures"

# Geometry of the independently-written database.
N, M, P, D, C = 12, 8, 2, 4, 4
SUB = M // D


@pytest.fixture(scope="module")
def wc(tmp_path_factory):
    """The protoc-generated independent codec module."""
    if shutil.which("protoc") is None:
        pytest.skip("protoc not available")
    out = tmp_path_factory.mktemp("gen_ref")
    try:
        subprocess.run(
            ["protoc", f"--proto_path={FIXTURES}",
             f"--python_out={out}", "wire_check.proto"],
            check=True, capture_output=True)
    except subprocess.CalledProcessError as e:  # pragma: no cover
        pytest.skip(f"protoc failed: {e.stderr.decode()}")
    spec = importlib.util.spec_from_file_location(
        "wire_check_pb2", out / "wire_check_pb2.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("wire_check_pb2", mod)
    try:
        spec.loader.exec_module(mod)
    except Exception as e:  # pragma: no cover - runtime/gencode mismatch
        pytest.skip(f"generated code unusable: {e}")
    return mod


def _store(base: Path, subdir: str, payload: bytes, compress: bool) -> str:
    """stdlib-only content-addressed store: zlib level 6 when compressed,
    name = URL-safe-base64(SHA-256(stored bytes)) without padding."""
    stored = zlib.compress(payload, 6) if compress else payload
    h = base64.urlsafe_b64encode(
        hashlib.sha256(stored).digest()).decode("ascii").rstrip("=")
    d = base / subdir if subdir else base
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{h}.binpb").write_bytes(stored)
    return h


@pytest.fixture(scope="module")
def ref_tree(wc, tmp_path_factory):
    """A full database tree produced by the independent writer."""
    rng = np.random.default_rng(7)
    base = tmp_path_factory.mktemp("refdb")

    centroids = rng.standard_normal((P, M)).astype(np.float32)
    codebooks = rng.standard_normal((D, C, SUB)).astype(np.float32)
    # Two partitions x 6 members each.
    vids = [uuid.uuid4() for _ in range(N)]
    members = [list(range(0, N // 2)), list(range(N // 2, N))]
    codes = rng.integers(0, C, (N, D)).astype(np.uint32)

    partition_ids = []
    for pi in range(P):
        part = wc.Partition(
            vector_size=M, num_divisions=D,
            centroid=centroids[pi].tolist())
        part.encoded_vectors.vector_size = D
        part.encoded_vectors.data.extend(
            codes[members[pi]].reshape(-1).tolist())
        for i in members[pi]:
            u = part.vector_ids.add()
            u.upper = vids[i].int >> 64
            u.lower = vids[i].int & ((1 << 64) - 1)
        partition_ids.append(
            _store(base, "partitions", part.SerializeToString(), True))

    cents = wc.VectorSet(vector_size=M, data=centroids.reshape(-1).tolist())
    partition_centroids_id = _store(
        base, "partitions", cents.SerializeToString(), False)

    codebook_ids = []
    for d in range(D):
        cb = wc.VectorSet(vector_size=SUB,
                          data=codebooks[d].reshape(-1).tolist())
        codebook_ids.append(
            _store(base, "codebooks", cb.SerializeToString(), False))

    # Attributes: datum_id (uint64) on every vector, label (string) on evens.
    attribute_names = ["datum_id", "label"]
    attributes_log_ids = []
    for pi in range(P):
        log = wc.AttributesLog(partition_id=partition_ids[pi])
        for i in members[pi]:
            e = log.entries.add()
            e.vector_id.upper = vids[i].int >> 64
            e.vector_id.lower = vids[i].int & ((1 << 64) - 1)
            e.name_index = 0
            e.value.uint64_value = i
            if i % 2 == 0:
                e2 = log.entries.add()
                e2.vector_id.upper = vids[i].int >> 64
                e2.vector_id.lower = vids[i].int & ((1 << 64) - 1)
                e2.name_index = 1
                e2.value.string_value = f"v{i}"
        attributes_log_ids.append(
            _store(base, "attributes", log.SerializeToString(), True))

    root = wc.Database(
        vector_size=M, num_partitions=P, num_divisions=D, num_codes=C,
        partition_ids=partition_ids,
        partition_centroids_id=partition_centroids_id,
        codebook_ids=codebook_ids,
        attributes_log_ids=attributes_log_ids,
        attribute_names=attribute_names)
    root_hash = _store(base, "", root.SerializeToString(), True)

    return dict(base=base, root=root_hash, centroids=centroids,
                codebooks=codebooks, codes=codes, vids=vids,
                members=members)


def _oracle(v, t, k, nprobe):
    """ADC k-NN straight from the raw arrays (db/build.rs:521-565)."""
    coarse = ((v[None] - t["centroids"]) ** 2).sum(-1)
    probed = np.argsort(coarse, kind="stable")[:nprobe]
    out = []
    for pi in probed:
        resid = (v - t["centroids"][pi]).reshape(D, SUB)
        table = ((resid[:, None, :] - t["codebooks"]) ** 2).sum(-1)
        for i in t["members"][pi]:
            dist = table[np.arange(D), t["codes"][i]].sum()
            out.append((float(dist), t["vids"][i]))
    out.sort(key=lambda r: r[0])
    return out[:k]


def test_sync_load_and_query(ref_tree):
    from flechasdb_tpu import LocalFileSystem, load_database

    t = ref_tree
    db = load_database(LocalFileSystem(t["base"]), f"{t['root']}.binpb")
    assert db.vector_size == M
    assert db.num_partitions == P

    rng = np.random.default_rng(13)
    for _ in range(3):
        v = rng.standard_normal(M).astype(np.float32)
        got = db.query(v, k=5, nprobe=P)
        want = _oracle(v, t, k=5, nprobe=P)
        assert [r.vector_id for r in got] == [w[1] for w in want]
        np.testing.assert_allclose(
            [r.squared_distance for r in got],
            [w[0] for w in want], rtol=1e-4)

    # Attribute replay through the independently-written set-op log.
    r0 = got[0]
    i = t["vids"].index(r0.vector_id)
    assert r0.get_attribute("datum_id") == i
    assert r0.get_attribute("label") == (f"v{i}" if i % 2 == 0 else None)


def test_sync_verify_all(ref_tree):
    from flechasdb_tpu import LocalFileSystem, load_database

    t = ref_tree
    # verify_all opt-in exercises hash verification on every artifact the
    # sync path reads (including the ones the reference quirkily skips).
    db = load_database(LocalFileSystem(t["base"]), f"{t['root']}.binpb")
    db.verify_all = True
    v = np.zeros(M, np.float32)
    assert len(db.query(v, k=3, nprobe=1)) == 3


def test_device_preload_query_batch(ref_tree):
    from flechasdb_tpu import LocalFileSystem, load_database

    t = ref_tree
    db = load_database(LocalFileSystem(t["base"]), f"{t['root']}.binpb")
    db.preload()
    rng = np.random.default_rng(29)
    vs = rng.standard_normal((4, M)).astype(np.float32)
    batches = db.query_batch(vs, k=5, nprobe=P)
    for b, v in zip(batches, vs):
        want = _oracle(v, t, k=5, nprobe=P)
        assert [r.vector_id for r in b] == [w[1] for w in want]


def test_async_load_and_query(ref_tree):
    from flechasdb_tpu.asyncdb import AsyncLocalFileSystem
    from flechasdb_tpu.asyncdb import load_database as load_async

    t = ref_tree

    async def run():
        db = await load_async(
            AsyncLocalFileSystem(t["base"]), f"{t['root']}.binpb")
        rng = np.random.default_rng(31)
        v = rng.standard_normal(M).astype(np.float32)
        got = await db.query(v, k=5, nprobe=P)
        want = _oracle(v, t, k=5, nprobe=P)
        assert [r.vector_id for r in got] == [w[1] for w in want]
        i = t["vids"].index(got[0].vector_id)
        assert await got[0].get_attribute("datum_id") == i

    asyncio.run(run())


def test_ours_parses_through_protoc(wc, tmp_path):
    """Every artifact of a flechasdb-tpu-written tree must parse through the
    protoc codec (and carry a correct stdlib-recomputed content hash)."""
    from flechasdb_tpu import DatabaseBuilder, LocalFileSystem, save_database

    rng = np.random.default_rng(3)
    x = rng.standard_normal((60, M)).astype(np.float32)
    db = (DatabaseBuilder(x).with_partitions(P).with_divisions(D)
          .with_clusters(C).with_seed(5).build())
    for i in range(0, 60, 3):
        db.set_attribute_at(i, ("datum_id", i))
    root_hash = save_database(db, LocalFileSystem(tmp_path))

    def load(path: Path, compressed: bool) -> bytes:
        stored = path.read_bytes()
        h = base64.urlsafe_b64encode(
            hashlib.sha256(stored).digest()).decode("ascii").rstrip("=")
        assert h == path.stem, f"bad content hash for {path}"
        return zlib.decompress(stored) if compressed else stored

    root = wc.Database()
    root.ParseFromString(load(tmp_path / f"{root_hash}.binpb", True))
    assert root.vector_size == M
    assert root.num_partitions == P
    assert len(root.partition_ids) == P
    assert len(root.codebook_ids) == D

    total_rows = 0
    for pid, aid in zip(root.partition_ids, root.attributes_log_ids):
        part = wc.Partition()
        part.ParseFromString(
            load(tmp_path / "partitions" / f"{pid}.binpb", True))
        assert part.vector_size == M
        assert part.encoded_vectors.vector_size == D
        n_i = len(part.vector_ids)
        assert len(part.encoded_vectors.data) == n_i * D
        total_rows += n_i

        log = wc.AttributesLog()
        log.ParseFromString(
            load(tmp_path / "attributes" / f"{aid}.binpb", True))
        assert log.partition_id == pid
        for e in log.entries:
            assert e.name_index < len(root.attribute_names)
    assert total_rows == 60

    cents = wc.VectorSet()
    cents.ParseFromString(load(
        tmp_path / "partitions" / f"{root.partition_centroids_id}.binpb",
        False))
    assert cents.vector_size == M
    assert len(cents.data) == P * M

    for cid in root.codebook_ids:
        cb = wc.VectorSet()
        cb.ParseFromString(load(tmp_path / "codebooks" / f"{cid}.binpb",
                                False))
        assert cb.vector_size == SUB
        assert len(cb.data) == C * SUB
