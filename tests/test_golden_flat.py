"""Golden fixture for the FLAT-tier wire format.

``tests/fixtures/flatgolden`` is a checked-in tree produced from
hand-built arrays (exact f32 quarters, fixed UUIDs, no RNG, no device
work — see the generator note below). The flat tier is an extension
format with no reference analogue (it implements the reference's
roadmap item, ``README.md:74``), so nothing outside this repo pins its
bytes: this fixture freezes decode AND byte-identical re-encode across
THIS framework's own versions, exactly the way ``extgolden`` pins root
fields 20/21.

What the tree deliberately covers:
  * TWO chunks (4096 + 5 rows) — the ``CHUNK_ROWS`` boundary;
  * chunk 2 holds a UUID with a zero lower 64-bit half, so chunk 1
    pins the bulk ``ids_raw`` record encoding and chunk 2 pins the
    per-message ``PUuid`` fallback (proto3 drops zero scalars, which
    would corrupt fixed-length bulk records — ``flat.py:366-371``);
  * a non-default metric ("dot", field encoding of a non-empty metric);
  * attribute logs with str and uint64 values (incl. one > 2³²) across
    both chunks, plus an empty-attrs chunk entry ordering.

Fixture generated once (round 5) by constructing ``FlatDatabase`` over
``x[i,j] = (((7i+3j) mod 23) - 11)/4`` with ``vector_ids[k] =
UUID(int=((k+1)<<64)|(k+1))`` (except index 4098 = ``UUID(int=
0xABCDEF<<64)``), attributes ``{ids[0]: {"name": "zero", "rank": 7},
ids[4097]: {"name": "tail"}, ids[4100]: {"rank": 2**40}}``, and saving
with :func:`flechasdb_tpu.flat.save_flat_database`.
"""

import asyncio
import base64
import hashlib
import uuid
from pathlib import Path

import numpy as np
import pytest

import flechasdb_tpu as fdb

FIXTURES = Path(__file__).parent / "fixtures"
FLATGOLDEN = FIXTURES / "flatgolden"


def _root() -> str:
    return (FIXTURES / "flatgolden_root.txt").read_text().strip()


@pytest.fixture(scope="module")
def golden():
    db = fdb.load_flat_database(fdb.LocalFileSystem(FLATGOLDEN),
                                f"{_root()}.binpb")
    q = np.load(FIXTURES / "flatgolden_query.npy")
    return db, q


def test_flat_fixture_bytes_are_content_addressed():
    """Every committed artifact's name must equal the URL-safe base64 of
    the SHA-256 of its (compressed) bytes — one byte of encode drift
    anywhere in the flat save path changes a hash and fails here."""
    files = sorted(FLATGOLDEN.rglob("*.binpb"))
    assert len(files) == 5          # root + 2 chunks + 2 attr logs
    for f in files:
        h = base64.urlsafe_b64encode(
            hashlib.sha256(f.read_bytes()).digest()
        ).rstrip(b"=").decode()
        assert f.stem == h, f.name


def test_flat_golden_decode_and_query(golden):
    db, q = golden
    assert db.metric == "dot"
    assert db.num_vectors == 4101
    assert db.vector_size == 8
    expected = [line.split(",") for line in
                (FIXTURES / "flatgolden_expected.txt")
                .read_text().splitlines()]
    res = db.query(q, k=5)
    assert len(res) == len(expected)
    for r, (vid, vi, dist) in zip(res, expected):
        assert r.vector_id == uuid.UUID(vid)
        assert r.vector_index == int(vi)
        assert r.squared_distance == pytest.approx(float(dist), abs=1e-5)


def test_flat_golden_both_id_encodings_and_attrs(golden):
    db, q = golden
    ids = [uuid.UUID(int=((k + 1) << 64) | (k + 1)) for k in range(4101)]
    ids[4098] = uuid.UUID(int=0xABCDEF << 64)   # zero lower half
    # chunk 1 (bulk ids_raw) and chunk 2 (per-message fallback) decode
    # to the same logical ids
    _, got0 = db._load_chunk(0)
    _, got1 = db._load_chunk(1)
    assert list(got0) == ids[:4096]
    assert list(got1) == ids[4096:]
    assert db.get_attribute(ids[0], "name") == "zero"
    assert db.get_attribute(ids[0], "rank") == 7
    assert db.get_attribute(ids[4097], "name") == "tail"
    assert db.get_attribute(ids[4100], "rank") == 2 ** 40
    assert db.get_attribute(ids[1], "name") is None


def test_flat_golden_async_parity(golden):
    db, q = golden
    from flechasdb_tpu.asyncdb.io import AsyncLocalFileSystem
    from flechasdb_tpu.flat import load_flat_database_async

    async def go():
        adb = await load_flat_database_async(
            AsyncLocalFileSystem(str(FLATGOLDEN)), f"{_root()}.binpb")
        return await adb.query(q, k=5)

    ares = asyncio.run(go())
    want = db.query(q, k=5)
    assert [r.vector_id for r in ares] == [r.vector_id for r in want]


def test_flat_golden_resave_is_byte_identical(golden, tmp_path):
    """Materialize → re-save must reproduce the exact tree hash-for-hash,
    pinning the ENCODE side (chunking, both id encodings, attr logs,
    metric field) — a silent format drift in any future version fails
    here before it can strand existing stored flat trees."""
    db, _ = golden
    mat = db.to_database()
    assert mat.metric == "dot"
    root2 = fdb.save_flat_database(mat, fdb.LocalFileSystem(str(tmp_path)))
    assert root2 == _root()
    src = {p.relative_to(FLATGOLDEN).as_posix()
           for p in FLATGOLDEN.rglob("*.binpb")}
    dst = {p.relative_to(tmp_path).as_posix()
           for p in tmp_path.rglob("*.binpb")}
    assert dst == src
