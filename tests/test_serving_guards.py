"""Serving-path guards: concurrent preload events and the masked-scan
HBM budget."""

import threading

import numpy as np
import pytest

import flechasdb_tpu as fdb
from flechasdb_tpu import events as ev
from flechasdb_tpu.serving import DeviceIndex


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((400, 16)).astype(np.float32)
    db = (fdb.DatabaseBuilder(x).with_partitions(8).with_divisions(4)
          .with_clusters(8).with_seed(2).build())
    base = tmp_path_factory.mktemp("db")
    root = fdb.save_database(db, fdb.LocalFileSystem(base))
    return x, base, root


def test_preload_concurrent_with_events(saved):
    x, base, root = saved
    db = fdb.load_database(fdb.LocalFileSystem(base), f"{root}.binpb")

    lock = threading.Lock()
    got = []

    def handler(e):
        with lock:
            got.append(e)

    db.preload(events=handler, max_workers=4)
    starts = [e for e in got if isinstance(e, ev.StartingPartitionLoad)]
    finishes = [e for e in got if isinstance(e, ev.FinishedPartitionLoad)]
    assert len(starts) == 8 and len(finishes) == 8
    assert {e.partition_index for e in finishes} == set(range(8))

    # Preloaded queries must agree with the cold host path.
    db2 = fdb.load_database(fdb.LocalFileSystem(base), f"{root}.binpb")
    v = x[3]
    warm = db.query(v, k=5, nprobe=8)
    cold = db2.query(v, k=5, nprobe=8)
    assert [r.vector_id for r in warm] == [r.vector_id for r in cold]

    # A second preload is a no-op (no further load events).
    before = len(got)
    db.preload(events=handler)
    assert len([e for e in got[before:]
                if isinstance(e, ev.StartingPartitionLoad)]) == 0


def test_masked_scan_chunks_to_hbm_budget():
    rng = np.random.default_rng(4)
    n, m, p, d, c = 3000, 32, 12, 4, 16
    centroids = rng.standard_normal((p, m)).astype(np.float32)
    codebooks = rng.standard_normal((d, c, m // d)).astype(np.float32)
    codes = rng.integers(0, c, (n, d)).astype(np.int32)
    pidx = rng.integers(0, p, n).astype(np.int32)
    q = rng.standard_normal((64, m)).astype(np.float32)

    full = DeviceIndex(centroids, codebooks, codes, pidx, layout="masked")
    assert full._masked_batch_limit() >= 64          # default budget: 1 go

    # A budget sized for ~7 queries forces chunking; results must be
    # identical to the single-shot batch.
    per_query = 4 * (p * d * c + p * m + n * d)
    tight = DeviceIndex(centroids, codebooks, codes, pidx, layout="masked",
                        hbm_budget_bytes=7 * per_query)
    assert 1 <= tight._masked_batch_limit() <= 7

    d_full, r_full, p_full = full.query(q, k=5, nprobe=3)
    d_chunk, r_chunk, p_chunk = tight.query(q, k=5, nprobe=3)
    np.testing.assert_allclose(d_chunk, d_full, rtol=1e-6)
    np.testing.assert_array_equal(r_chunk, r_full)
    np.testing.assert_array_equal(p_chunk, p_full)


def test_masked_limit_never_zero():
    rng = np.random.default_rng(4)
    idx = DeviceIndex(
        rng.standard_normal((4, 8)).astype(np.float32),
        rng.standard_normal((2, 4, 4)).astype(np.float32),
        rng.integers(0, 4, (100, 2)).astype(np.int32),
        rng.integers(0, 4, 100).astype(np.int32),
        layout="masked", hbm_budget_bytes=1)
    assert idx._masked_batch_limit() == 1
    d, r, p = idx.query(rng.standard_normal((3, 8)).astype(np.float32),
                        k=2, nprobe=2)
    assert d.shape == (3, 2)


def test_sharded_masked_scan_chunks_to_hbm_budget():
    """ShardedIndex's masked path must honour the same per-device HBM
    budget as DeviceIndex (the batch is replicated, so every device
    materializes the full [B, P, D, C] tables) — a tight budget forces
    chunking with identical results, tail chunk zero-padded so only one
    program shape ever compiles."""
    from flechasdb_tpu.parallel import corpus_mesh
    from flechasdb_tpu.serving import ShardedIndex

    rng = np.random.default_rng(9)
    n, m, p, d, c = 3000, 32, 12, 4, 16
    centroids = rng.standard_normal((p, m)).astype(np.float32)
    codebooks = rng.standard_normal((d, c, m // d)).astype(np.float32)
    codes = rng.integers(0, c, (n, d)).astype(np.int32)
    pidx = rng.integers(0, p, n).astype(np.int32)
    q = rng.standard_normal((64, m)).astype(np.float32)

    mesh = corpus_mesh()
    full = ShardedIndex(centroids, codebooks, codes, pidx,
                        layout="masked", mesh=mesh)
    n_local = -(-n // mesh.devices.size)
    per_query = 4 * (p * d * c + p * m + n_local * d)
    tight = ShardedIndex(centroids, codebooks, codes, pidx,
                         layout="masked",
                         hbm_budget_bytes=7 * per_query, mesh=mesh)

    d_full, r_full, p_full = full.query(q, k=5, nprobe=3)
    d_chunk, r_chunk, p_chunk = tight.query(q, k=5, nprobe=3)
    np.testing.assert_allclose(d_chunk, d_full, rtol=1e-6)
    np.testing.assert_array_equal(r_chunk, r_full)
    np.testing.assert_array_equal(p_chunk, p_full)


def test_query_rerank_fused_matches_masked_fallback(rng):
    """`DeviceIndex.query_rerank` must return identical results on the
    fused bucketed path and the masked-layout two-step fallback (the
    exact re-score makes ties well-separated on random data)."""
    import jax.numpy as jnp

    from flechasdb_tpu.serving import DeviceIndex

    n, m, p, d, c = 400, 32, 6, 4, 16
    x = rng.standard_normal((n, m)).astype(np.float32)
    centroids = rng.standard_normal((p, m)).astype(np.float32)
    codebooks = rng.standard_normal((d, c, m // d)).astype(np.float32)
    codes = rng.integers(0, c, (n, d)).astype(np.int32)
    pidx = rng.integers(0, p, n).astype(np.int32)
    q = x[:5] + 0.01 * rng.standard_normal((5, m)).astype(np.float32)
    xd = jnp.asarray(x)

    buck = DeviceIndex(centroids, codebooks, codes, pidx,
                       layout="bucketed")
    mask = DeviceIndex(centroids, codebooks, codes, pidx, layout="masked")
    db_, rb = buck.query_rerank(q, xd, k=5, nprobe=4, rerank=30)
    dm, rm = mask.query_rerank(q, xd, k=5, nprobe=4, rerank=30)
    np.testing.assert_array_equal(rb, rm)
    np.testing.assert_allclose(db_, dm, rtol=1e-5, atol=1e-5)
