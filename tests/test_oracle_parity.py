"""Quality parity: the device build must match the NumPy oracle of the
reference's exact algorithm.

RNG streams can never be bit-identical across implementations
(SURVEY.md §7 "hard parts"), so parity is asserted on the quantities that
define quality: k-means inertia, PQ reconstruction error, and recall@10
against exact search at equal ``(P, D, C)`` on the same clustered
(GMM, descriptor-like) data. The device ADC query kernel is additionally
checked for *exact* agreement with the oracle's ADC scan when both consume
the same model — that part is deterministic math, not a stochastic match.
"""

import numpy as np
import pytest

from flechasdb_tpu import oracle
from flechasdb_tpu.utils.synth import gmm_corpus, gmm_pair


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(44)
    x, q = gmm_pair(rng, 6000, 200, 32, n_clusters=48, intrinsic=8)
    return x, q


def _exact_topk(x, q, k):
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def _recall(rows_list, gt):
    hits = sum(len(set(np.asarray(r).tolist()) & set(g.tolist()))
               for r, g in zip(rows_list, gt))
    return hits / gt.size


def test_kmeans_inertia_parity(data):
    """Device k-means quality == oracle k-means quality (within seed noise)."""
    import jax

    from flechasdb_tpu.ops import kmeans as tk

    x, _ = data
    k = 16
    ours, theirs = [], []
    for seed in range(3):
        r = tk.fit(np.asarray(x)[None], k, jax.random.key(seed))
        ours.append(oracle.inertia(x, np.asarray(r.centroids[0]),
                                   np.asarray(r.indices[0])))
        o = oracle.kmeans(x, k, np.random.default_rng(seed))
        theirs.append(oracle.inertia(x, o.centroids, o.indices))
    ratio = np.mean(ours) / np.mean(theirs)
    assert 0.9 < ratio < 1.1, (
        f"device k-means inertia off oracle by {ratio:.3f}x "
        f"(ours {ours}, oracle {theirs})")


def test_build_recall_parity(data):
    """Full-build recall@10 at equal (P, D, C): device vs oracle."""
    import jax

    from flechasdb_tpu.ops.adc import query_masked_scan
    from flechasdb_tpu.parallel.build import _build_step

    x, q = data
    p, d, c, k = 16, 4, 16, 10
    gt = _exact_topk(x, q, k)

    built = _build_step(np.asarray(x), jax.random.key(0), p=p, d=d, c=c)
    ob = oracle.build(x, p, d, c, np.random.default_rng(0))

    # PQ reconstruction error (total ADC self-distance) — equal-quality
    # codebooks must encode the corpus equally well.
    def pq_err(codebooks, codes, centroids, pidx):
        resid = x - np.asarray(centroids)[np.asarray(pidx)]
        sub = x.shape[1] // d
        rec = np.concatenate([
            np.asarray(codebooks)[di][np.asarray(codes)[:, di]]
            for di in range(d)], axis=1)
        return float(((resid - rec) ** 2).sum())

    e_dev = pq_err(built.codebooks, built.codes,
                   built.partition_centroids, built.partition_indices)
    e_orc = pq_err(ob.codebooks, ob.codes,
                   ob.partition_centroids, ob.partition_indices)
    assert 0.85 < e_dev / e_orc < 1.18, (
        f"PQ reconstruction error mismatch: device {e_dev:.1f} "
        f"vs oracle {e_orc:.1f}")

    for nprobe in (2, p):
        _, rows, _ = query_masked_scan(
            np.asarray(q), built.partition_centroids, built.codebooks,
            built.codes.astype(np.int32),
            built.partition_indices.astype(np.int32),
            k=k, nprobe=nprobe)
        r_dev = _recall(list(np.asarray(rows)), gt)
        r_orc = _recall([oracle.adc_query(qq, ob, k, nprobe)[0]
                         for qq in q], gt)
        assert abs(r_dev - r_orc) < 0.05, (
            f"recall@10 nprobe={nprobe}: device {r_dev:.3f} "
            f"vs oracle {r_orc:.3f}")


def test_device_adc_exactly_matches_oracle_scan(data):
    """Same model in -> same neighbors out: the fused device kernel computes
    exactly the reference's ADC math (db/build.rs:521-565)."""
    from flechasdb_tpu.ops.adc import query_masked_scan

    x, q = data
    q = q[:32]
    p, d, c, k = 8, 4, 16, 10
    ob = oracle.build(x[:2000], p, d, c, np.random.default_rng(5))

    dists, rows, _ = query_masked_scan(
        np.asarray(q), np.asarray(ob.partition_centroids),
        np.asarray(ob.codebooks), np.asarray(ob.codes, np.int32),
        np.asarray(ob.partition_indices, np.int32), k=k, nprobe=3)
    dists, rows = np.asarray(dists), np.asarray(rows)
    for b, qq in enumerate(q):
        orc_rows, orc_d = oracle.adc_query(qq, ob, k, nprobe=3)
        # Distances must agree to float tolerance; rows may swap on ties.
        np.testing.assert_allclose(dists[b], orc_d, rtol=1e-4, atol=1e-4)
        mismatch = rows[b] != orc_rows
        if mismatch.any():
            np.testing.assert_allclose(
                dists[b][mismatch],
                orc_d[mismatch], rtol=1e-5, atol=1e-5)


def test_oracle_f64_build(data):
    """The oracle is the f64-capable host path (numbers.rs:6-111 analogue):
    the full pipeline runs end-to-end in float64."""
    x, q = data
    x64 = np.asarray(x[:1500], np.float64)
    ob = oracle.build(x64, 4, 4, 8, np.random.default_rng(1),
                      dtype=np.float64)
    assert ob.partition_centroids.dtype == np.float64
    assert ob.codebooks.dtype == np.float64
    rows, dists = oracle.adc_query(np.asarray(q[0], np.float64), ob,
                                   k=5, nprobe=4)
    assert len(rows) == 5 and dists.dtype == np.float64
    assert (np.diff(dists) >= 0).all()


def test_oracle_kmeans_semantics():
    """Edge semantics pinned by the reference: N == k shortcut, convergence
    before reassignment, empty-input error."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    r = oracle.kmeans(x, 8, rng)
    np.testing.assert_array_equal(r.indices, np.arange(8))
    assert r.rounds == 0

    with pytest.raises(ValueError):
        oracle.kmeans(x, 9, rng)

    # Two well-separated blobs, k=2: must converge quickly and split them.
    a = rng.standard_normal((50, 4)).astype(np.float32) + 10
    b = rng.standard_normal((50, 4)).astype(np.float32) - 10
    r = oracle.kmeans(np.concatenate([a, b]), 2, rng)
    assert r.rounds < oracle.MAX_ROUNDS
    assert len(set(r.indices[:50])) == 1 and len(set(r.indices[50:])) == 1


def test_gmm_corpus_is_clustered():
    """The synthetic generator must actually produce clustered data: mean
    nearest-neighbor distance far below mean random-pair distance."""
    rng = np.random.default_rng(9)
    x = gmm_corpus(rng, 2000, 32, n_clusters=32, intrinsic=8)
    d = ((x[:200, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d[:, :200], np.inf)
    nn = d.min(axis=1).mean()
    rand = d[np.isfinite(d)].mean()
    assert nn < 0.25 * rand, f"not clustered: nn {nn:.2f} vs rand {rand:.2f}"


def test_caps_parity_at_engaging_scale():
    """The two quality-affecting shortcuts — k-means++ seeding on a
    subsample (PARITY.md divergence #2) and PQ codebook training under
    ``pq_cap`` — must not cost recall at a scale where they ENGAGE
    (below both thresholds a regression in the subsampled paths would
    be invisible)."""
    import jax

    from flechasdb_tpu.ops import kmeans as tk
    from flechasdb_tpu.ops.adc import query_masked_scan

    rng = np.random.default_rng(7)
    x, q = gmm_pair(rng, 50_000, 100, 32, n_clusters=64, intrinsic=8)
    p, d, c, k = 16, 4, 16, 10
    gt = _exact_topk(x, q, k)

    from flechasdb_tpu.parallel.build import _build_step

    def build(pq_cap, coarse_cap=1 << 30):
        return _build_step(np.asarray(x), jax.random.key(3), p=p, d=d, c=c,
                           pq_cap=pq_cap, coarse_cap=coarse_cap)

    def measure(built):
        resid = x - np.asarray(built.partition_centroids)[
            np.asarray(built.partition_indices)]
        inertia = float((resid ** 2).sum())
        rec = np.concatenate([
            np.asarray(built.codebooks)[di][np.asarray(built.codes)[:, di]]
            for di in range(d)], axis=1)
        err = float(((resid - rec) ** 2).sum())
        _, rows, _ = query_masked_scan(
            np.asarray(q), built.partition_centroids, built.codebooks,
            built.codes.astype(np.int32),
            built.partition_indices.astype(np.int32), k=k, nprobe=4)
        return inertia, err, _recall(list(np.asarray(rows)), gt)

    # Caps ON: N=50k > seed cap (max(4096, 32·16)=4096), pq_cap=4096 and
    # coarse_cap=8192 → the seeding subsample, the PQ training subsample
    # AND the coarse Lloyd-round subsample (ops.kmeans train_cap) all
    # engage.
    assert 50_000 > tk._seed_cap(p)
    in_on, err_on, rec_on = measure(build(pq_cap=4096, coarse_cap=8192))

    # Caps OFF: full-corpus seeding (reference semantics,
    # kmeans.rs:142-229) and full-corpus coarse/PQ training.
    orig = tk._seed_cap
    tk._seed_cap = lambda k_: 1 << 30
    try:
        in_off, err_off, rec_off = measure(build(pq_cap=1 << 30))
    finally:
        tk._seed_cap = orig

    # Coarse clustering inertia and PQ reconstruction error are the
    # low-variance quality signals. recall@10 at this deliberately hard
    # config (nprobe 4/16, no rerank) sits near 0.07 with a measured
    # key-to-key spread of ±0.015 EACH side (keys 0-3: caps-off
    # 0.051-0.082, caps-on 0.059-0.075, equal means) — an engaged cap
    # reroutes the whole key stream, so single-key recall deltas below
    # that spread are noise, not quality loss.
    assert 0.95 < in_on / in_off < 1.05, (
        f"coarse inertia caps-on/off ratio {in_on/in_off:.3f}")
    assert 0.95 < err_on / err_off < 1.06, (
        f"PQ reconstruction error caps-on/off ratio {err_on/err_off:.3f}")
    assert abs(rec_on - rec_off) < 0.03, (
        f"recall@10 caps-on {rec_on:.3f} vs caps-off {rec_off:.3f}")


def test_builder_f64_dtype_seam(tmp_path):
    """DatabaseBuilder(dtype=np.float64) routes the build through the f64
    oracle pipeline and serves f32 end to end: build → save → load →
    query round-trips."""
    import flechasdb_tpu as fdb

    rng = np.random.default_rng(3)
    x = rng.standard_normal((400, 16)).astype(np.float64)
    db = (fdb.DatabaseBuilder(x, dtype=np.float64).with_partitions(4)
          .with_divisions(4).with_clusters(8).with_seed(11).build())
    assert db.partition_centroids.dtype == np.float32
    db.set_attribute_at(0, ("tag", 7))

    root = fdb.save_database(db, fdb.LocalFileSystem(tmp_path))
    db2 = fdb.load_database(fdb.LocalFileSystem(tmp_path), f"{root}.binpb")
    got = db2.query(x[0].astype(np.float32), k=5, nprobe=4)
    assert len(got) == 5
    # self-match: nearest neighbour of a corpus vector is itself
    assert got[0].vector_id == db.vector_ids[0]

    # overflow check: values finite in f64 but beyond f32 range must raise
    import pytest as _pytest
    bad = x.copy()
    bad[0, 0] = 1e39
    with _pytest.raises(fdb.InvalidArgs):
        (fdb.DatabaseBuilder(bad, dtype=np.float64).with_partitions(4)
         .with_divisions(4).with_clusters(8).with_seed(1).build())
