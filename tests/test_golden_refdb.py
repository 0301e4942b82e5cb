"""Golden INDEPENDENT-WRITER fixture.

``tests/fixtures/refdb`` is a committed database tree produced once by the
independent writer of ``test_reference_written.py`` — protoc-generated
codec + stdlib zlib/sha256/base64 only, mirroring the reference's
serializer (``db/build/proto.rs:25-63``) and content store
(``io.rs:90-129``) — with its raw arrays in ``refdb_meta.npz``. Unlike the
live cross-check (which regenerates both sides each run, so paired
regressions could cancel out), these bytes pin the decode path against the
PAST: any codec change that breaks reference-written trees fails here, no
protoc needed.
"""

import asyncio
import json
import uuid
from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).parent / "fixtures"
REFDB = FIXTURES / "refdb"
M, P, D, C = 8, 2, 4, 4
SUB = M // D


def _meta():
    z = np.load(FIXTURES / "refdb_meta.npz", allow_pickle=True)
    return dict(
        centroids=z["centroids"], codebooks=z["codebooks"],
        codes=z["codes"],
        vids=[uuid.UUID(int=int(u)) for u in z["vids"]],
        members=[z["members0"].tolist(), z["members1"].tolist()],
    )


def _root() -> str:
    return json.loads((FIXTURES / "refdb_root.json").read_text())["root"]


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


def test_fixture_bytes_are_content_addressed():
    """Every committed artifact's name must equal the URL-safe-base64
    SHA-256 of its stored bytes — the tree is byte-pinned, not just
    parse-pinned."""
    import base64
    import hashlib

    files = sorted(REFDB.rglob("*.binpb"))
    assert len(files) == 10  # root + 2 parts + centroids + 4 cbs + 2 logs
    for f in files:
        h = base64.urlsafe_b64encode(
            hashlib.sha256(f.read_bytes()).digest()
        ).decode("ascii").rstrip("=")
        assert h == f.stem, f"content hash mismatch for {f}"


def test_golden_refdb_sync_query_and_attributes():
    from flechasdb_tpu import LocalFileSystem, load_database

    t = _meta()
    db = load_database(LocalFileSystem(REFDB), f"{_root()}.binpb")
    assert db.vector_size == M and db.num_partitions == P
    db.verify_all = True

    rng = np.random.default_rng(13)
    for _ in range(3):
        v = rng.standard_normal(M).astype(np.float32)
        got = db.query(v, k=5, nprobe=P)
        want = _oracle(v, t, k=5, nprobe=P)
        assert [r.vector_id for r in got] == [w[1] for w in want]
        np.testing.assert_allclose(
            [r.squared_distance for r in got],
            [w[0] for w in want], rtol=1e-4)

    i = t["vids"].index(got[0].vector_id)
    assert got[0].get_attribute("datum_id") == i
    assert got[0].get_attribute("label") == (f"v{i}" if i % 2 == 0 else None)


def test_golden_refdb_async_load():
    from flechasdb_tpu.asyncdb import AsyncLocalFileSystem
    from flechasdb_tpu.asyncdb import load_database as load_async

    t = _meta()

    async def run():
        db = await load_async(AsyncLocalFileSystem(REFDB),
                              f"{_root()}.binpb")
        v = np.zeros(M, np.float32)
        got = await db.query(v, k=3, nprobe=P)
        want = _oracle(v, t, k=3, nprobe=P)
        assert [r.vector_id for r in got] == [w[1] for w in want]

    asyncio.run(run())
