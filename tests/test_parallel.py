"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The reference has no distributed components (SURVEY.md §2); these tests pin
the device-native scale-out design instead: sharded query must agree exactly
with the single-device fused kernel, and the sharded build must produce a
valid index end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flechasdb_tpu.ops.adc import query_masked_scan
from flechasdb_tpu.parallel import (
    build_sharded,
    corpus_mesh,
    query_sharded,
    shard_corpus,
)


@pytest.fixture(scope="module")
def mesh():
    return corpus_mesh(jax.devices("cpu"))


def _random_index(rng, n=512, m=64, p=8, d=4, c=16):
    centroids = rng.standard_normal((p, m)).astype(np.float32)
    codebooks = rng.standard_normal((d, c, m // d)).astype(np.float32)
    codes = rng.integers(0, c, (n, d)).astype(np.int32)
    pidx = rng.integers(0, p, n).astype(np.int32)
    return centroids, codebooks, codes, pidx


def test_sharded_query_matches_single_device(rng, mesh):
    centroids, codebooks, codes, pidx = _random_index(rng)
    q = rng.standard_normal((5, centroids.shape[1])).astype(np.float32)

    ref_d, ref_r, ref_p = query_masked_scan(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        jnp.asarray(codes), jnp.asarray(pidx), k=10, nprobe=3)

    codes_s, pidx_s = shard_corpus(mesh, codes, pidx)
    sh_d, sh_r, sh_p = query_sharded(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        codes_s, pidx_s, mesh=mesh, k=10, nprobe=3)

    np.testing.assert_allclose(np.asarray(sh_d), np.asarray(ref_d),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(sh_p), np.asarray(ref_p))
    # Rows may reorder only among exact distance ties.
    ref_rows, sh_rows = np.asarray(ref_r), np.asarray(sh_r)
    for b in range(len(q)):
        mismatched = ref_rows[b] != sh_rows[b]
        if mismatched.any():
            d_ref = np.asarray(ref_d)[b][mismatched]
            d_sh = np.asarray(sh_d)[b][mismatched]
            np.testing.assert_allclose(d_ref, d_sh, rtol=1e-6)


def test_sharded_query_unpadded_corpus(rng, mesh):
    """N not divisible by the mesh size exercises the pad-row masking."""
    centroids, codebooks, codes, pidx = _random_index(rng, n=509)
    q = rng.standard_normal((3, centroids.shape[1])).astype(np.float32)

    ref_d, _, _ = query_masked_scan(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        jnp.asarray(codes), jnp.asarray(pidx), k=7, nprobe=8)

    codes_s, pidx_s = shard_corpus(mesh, codes, pidx)
    sh_d, sh_r, _ = query_sharded(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        codes_s, pidx_s, mesh=mesh, k=7, nprobe=8)

    np.testing.assert_allclose(np.asarray(sh_d), np.asarray(ref_d),
                               rtol=1e-5, atol=1e-5)
    # No padding row (>= 509) may ever be returned.
    assert np.all(np.asarray(sh_r) < 509)


def test_sharded_build_end_to_end(rng, mesh):
    n, m, p, d, c = 256, 32, 4, 4, 8
    x = rng.standard_normal((n, m)).astype(np.float32)

    built = build_sharded(x, p, d, c, jax.random.key(7), mesh=mesh)
    assert built.partition_centroids.shape == (p, m)
    assert built.codebooks.shape == (d, c, m // d)
    assert built.codes.shape == (n, d)
    assert np.asarray(built.partition_indices).min() >= 0
    assert np.asarray(built.partition_indices).max() < p
    assert np.asarray(built.codes).min() >= 0
    assert np.asarray(built.codes).max() < c

    # Query the built index sharded; nearest neighbour of a corpus vector
    # should usually be itself — sanity-check recall over a few probes.
    codes_s, pidx_s = shard_corpus(
        mesh, np.asarray(built.codes), np.asarray(built.partition_indices))
    q = x[:8]
    _, rows, _ = query_sharded(
        jnp.asarray(q), built.partition_centroids, built.codebooks,
        codes_s, pidx_s, mesh=mesh, k=1, nprobe=p)
    hits = (np.asarray(rows)[:, 0] == np.arange(8)).mean()
    assert hits >= 0.5


def test_sharded_build_matches_unsharded(rng, mesh):
    """Same key ⇒ sharded and single-device builds agree numerically."""
    from flechasdb_tpu.parallel.build import _build_step

    n, m, p, d, c = 128, 16, 4, 2, 8
    x = rng.standard_normal((n, m)).astype(np.float32)
    key = jax.random.key(3)

    sharded = build_sharded(x, p, d, c, key, mesh=mesh)
    single = _build_step(jnp.asarray(x), key, p=p, d=d, c=c)

    np.testing.assert_allclose(
        np.asarray(sharded.partition_centroids),
        np.asarray(single.partition_centroids), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(sharded.partition_indices),
        np.asarray(single.partition_indices))
    np.testing.assert_array_equal(
        np.asarray(sharded.codes), np.asarray(single.codes))


def test_sharded_build_unpadded_corpus(rng, mesh):
    """N not divisible by the mesh size: zero-pad rows must not perturb
    the clustering (count correction) and never leak into outputs."""
    from flechasdb_tpu.parallel.build import _build_step

    n, m, p, d, c = 251, 16, 4, 2, 8
    x = rng.standard_normal((n, m)).astype(np.float32)
    key = jax.random.key(5)

    sharded = build_sharded(x, p, d, c, key, mesh=mesh)
    single = _build_step(jnp.asarray(x), key, p=p, d=d, c=c)

    assert sharded.partition_indices.shape == (n,)
    assert sharded.codes.shape == (n, d)
    np.testing.assert_allclose(
        np.asarray(sharded.partition_centroids),
        np.asarray(single.partition_centroids), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(sharded.partition_indices),
        np.asarray(single.partition_indices))
    np.testing.assert_array_equal(
        np.asarray(sharded.codes), np.asarray(single.codes))


def test_sharded_build_pq_cap_engaged(rng, mesh):
    """A reduced pq_cap routes the sharded build through the subsampled
    codebook training + chunked encode, matching the single-chip path."""
    from flechasdb_tpu.parallel.build import _build_step

    n, m, p, d, c = 512, 16, 4, 2, 8
    x = rng.standard_normal((n, m)).astype(np.float32)
    key = jax.random.key(9)

    sharded = build_sharded(x, p, d, c, key, mesh=mesh, pq_cap=256)
    single = _build_step(jnp.asarray(x), key, p=p, d=d, c=c, pq_cap=256)

    np.testing.assert_allclose(
        np.asarray(sharded.codebooks), np.asarray(single.codebooks),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(sharded.codes), np.asarray(single.codes))


def test_sharded_build_coarse_cap_engaged(rng, mesh):
    """A reduced coarse_cap routes the sharded build's Lloyd rounds through
    the re-sharded subsample + full sharded assignment, matching the
    single-chip capped path (same key ⇒ same subsample rows)."""
    from flechasdb_tpu.parallel.build import _build_step

    n, m, p, d, c = 512, 16, 4, 2, 8
    x = rng.standard_normal((n, m)).astype(np.float32)
    key = jax.random.key(13)

    sharded = build_sharded(x, p, d, c, key, mesh=mesh, coarse_cap=128)
    single = _build_step(jnp.asarray(x), key, p=p, d=d, c=c,
                         coarse_cap=128)

    np.testing.assert_allclose(
        np.asarray(sharded.partition_centroids),
        np.asarray(single.partition_centroids), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(sharded.partition_indices),
        np.asarray(single.partition_indices))
    np.testing.assert_array_equal(
        np.asarray(sharded.codes), np.asarray(single.codes))


def test_sharded_exact_matches_single_device(rng, mesh):
    from flechasdb_tpu.ops.exact import exact_topk
    from flechasdb_tpu.parallel import exact_sharded, shard_flat

    x = rng.standard_normal((501, 32)).astype(np.float32)
    q = rng.standard_normal((4, 32)).astype(np.float32)

    ref_d, ref_r = exact_topk(jnp.asarray(q), jnp.asarray(x), k=9)
    xs, n = shard_flat(mesh, x)
    sh_d, sh_r = exact_sharded(jnp.asarray(q), xs, mesh=mesh, k=9, n=n)

    np.testing.assert_allclose(np.asarray(sh_d), np.asarray(ref_d),
                               rtol=1e-5, atol=1e-5)
    assert np.all(np.asarray(sh_r) < 501)
    rd, sd = np.asarray(ref_d), np.asarray(sh_d)
    rr, sr = np.asarray(ref_r), np.asarray(sh_r)
    for b in range(4):
        diff = rr[b] != sr[b]
        if diff.any():
            np.testing.assert_allclose(rd[b][diff], sd[b][diff], rtol=1e-6)


def test_stored_database_sharded_serving(rng, mesh, tmp_path):
    """StoredDatabase.preload(mesh=...) serves queries SPMD over the mesh
    with results identical to single-device serving."""
    import flechasdb_tpu as fdb

    x = rng.standard_normal((600, 32)).astype(np.float32)
    db = (fdb.DatabaseBuilder(x).with_partitions(6).with_divisions(4)
          .with_clusters(16).with_seed(8).build())
    root = fdb.save_database(db, fdb.LocalFileSystem(tmp_path))

    single = fdb.load_database(fdb.LocalFileSystem(tmp_path),
                               f"{root}.binpb")
    single.preload()
    sharded = fdb.load_database(fdb.LocalFileSystem(tmp_path),
                                f"{root}.binpb")
    sharded.preload(mesh=mesh)
    assert sharded._dev[0].layout.startswith("sharded")

    a = single.query_batch(x[:16], k=5, nprobe=3)
    b = sharded.query_batch(x[:16], k=5, nprobe=3)
    for ra, rb in zip(a, b):
        assert [r.vector_id for r in ra] == [r.vector_id for r in rb]
        for qa, qb in zip(ra, rb):
            assert qa.squared_distance == pytest.approx(
                qb.squared_distance, rel=1e-5)


# -------------------------------------------- sharded bucketed serving ----


def test_sharded_bucketed_matches_single_device(rng, mesh):
    """Partition-sharded bucketed scan == single-device bucketed scan
    (global rows, distances, probed sets)."""
    from flechasdb_tpu.ops.bucketed import bucketize, query_bucketed
    from flechasdb_tpu.parallel.bucketed import (query_bucketed_sharded,
                                                 shard_buckets)

    centroids, codebooks, codes, pidx = _random_index(
        rng, n=700, m=64, p=13, d=4, c=16)  # P=13: pad partitions engage
    q = rng.standard_normal((6, 64)).astype(np.float32)
    buckets = bucketize(codes, pidx, 13, pack="auto")

    ref_d, ref_r, ref_p = query_bucketed(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        buckets, k=9, nprobe=5)

    sb = shard_buckets(mesh, buckets)
    sh_d, sh_r, sh_p = query_bucketed_sharded(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        sb, mesh=mesh, k=9, nprobe=5)

    np.testing.assert_allclose(np.asarray(sh_d), np.asarray(ref_d),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(sh_p), np.asarray(ref_p))
    ref_rows, sh_rows = np.asarray(ref_r), np.asarray(sh_r)
    for b in range(len(q)):
        mismatched = ref_rows[b] != sh_rows[b]
        if mismatched.any():  # only exact-distance ties may reorder
            np.testing.assert_allclose(
                np.asarray(ref_d)[b][mismatched],
                np.asarray(sh_d)[b][mismatched], rtol=1e-6)


def test_sharded_bucketed_row_mask(rng, mesh):
    """Attribute filtering on the sharded bucketed path: no masked row
    may be returned, and results match the single-device filtered scan."""
    from flechasdb_tpu.ops.bucketed import bucketize, query_bucketed
    from flechasdb_tpu.parallel.bucketed import (query_bucketed_sharded,
                                                 shard_buckets)

    centroids, codebooks, codes, pidx = _random_index(
        rng, n=600, m=32, p=8, d=4, c=16)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    mask = rng.random(600) < 0.5
    buckets = bucketize(codes, pidx, 8)

    ref_d, ref_r, _ = query_bucketed(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        buckets, row_mask=jnp.asarray(mask), k=7, nprobe=8)
    sb = shard_buckets(mesh, buckets)
    sh_d, sh_r, _ = query_bucketed_sharded(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        sb, None, jnp.asarray(mask), mesh=mesh, k=7, nprobe=8)

    np.testing.assert_allclose(np.asarray(sh_d), np.asarray(ref_d),
                               rtol=1e-5, atol=1e-5)
    finite = np.isfinite(np.asarray(sh_d))
    assert mask[np.asarray(sh_r)[finite]].all()


def test_sharded_index_bucketed_layout(rng, mesh):
    """ShardedIndex defaults to the bucketed layout when padding is sane
    and agrees with DeviceIndex row for row."""
    from flechasdb_tpu.serving import DeviceIndex, ShardedIndex

    centroids, codebooks, codes, pidx = _random_index(
        rng, n=800, m=64, p=8, d=4, c=16)
    q = rng.standard_normal((5, 64)).astype(np.float32)

    single = DeviceIndex(centroids, codebooks, codes, pidx)
    assert single.layout == "bucketed"
    sharded = ShardedIndex(centroids, codebooks, codes, pidx, mesh=mesh)
    assert sharded.layout == "sharded-bucketed"

    ds, rs, ps = single.query(q, k=6, nprobe=4)
    dh, rh, ph = sharded.query(q, k=6, nprobe=4)
    np.testing.assert_allclose(dh, ds, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ph, ps)
    mismatched = rs != rh
    if mismatched.any():
        np.testing.assert_allclose(ds[mismatched], dh[mismatched],
                                   rtol=1e-6)


def test_sharded_range_matches_single_device(rng, mesh):
    """ShardedIndex.query_range == DeviceIndex.query_range on both
    layouts, with and without a row mask (the sharded candidate combine
    — pmin/psum of owned probe slots, all_gather of local key columns —
    must reproduce the single-chip candidate set exactly)."""
    from flechasdb_tpu.serving import DeviceIndex, ShardedIndex

    centroids, codebooks, codes, pidx = _random_index(
        rng, n=700, m=32, p=8, d=4, c=16)
    q = rng.standard_normal((3, 32)).astype(np.float32)
    mask = rng.random(700) < 0.6

    for layout in ("bucketed", "masked"):
        single = DeviceIndex(centroids, codebooks, codes, pidx,
                             layout=layout)
        sharded = ShardedIndex(centroids, codebooks, codes, pidx,
                               layout=layout, mesh=mesh)
        probe = single.query(q, k=5, nprobe=8)[0]
        radius = float(np.median(probe[np.isfinite(probe)]))
        for rm in (None, mask):
            ref = single.query_range(q, radius, nprobe=8, row_mask=rm)
            got = sharded.query_range(q, radius, nprobe=8, row_mask=rm)
            assert len(ref) == len(got)
            for (rr, rk), (gr, gk) in zip(ref, got):
                np.testing.assert_array_equal(np.sort(gr), np.sort(rr))
                np.testing.assert_allclose(np.sort(gk), np.sort(rk),
                                           rtol=1e-5, atol=1e-5)
                if rm is not None:
                    assert mask[gr].all()


def test_rerank_sharded_matches_exact(rng, mesh):
    """rerank_sharded == the in-memory _rerank_exact for both metrics
    (same candidates, same inf-for-invalid semantics, corpus sharded)."""
    from flechasdb_tpu.build import _rerank_exact
    from flechasdb_tpu.parallel import rerank_sharded, shard_flat

    n, m, b, r, k = 500, 24, 4, 16, 6
    x = rng.standard_normal((n, m)).astype(np.float32)
    q = rng.standard_normal((b, m)).astype(np.float32)
    rows = np.stack([rng.choice(n, r, replace=False) for _ in range(b)])
    valid = rng.random((b, r)) < 0.8
    valid[:, :k] = True            # keep >= k live candidates per query

    xs, _ = shard_flat(mesh, x)
    for metric in ("l2", "dot"):
        ref_d, ref_r = _rerank_exact(
            jnp.asarray(q), jnp.asarray(rows), jnp.asarray(valid),
            jnp.asarray(x), k=k, metric=metric)
        got_d, got_r = rerank_sharded(
            jnp.asarray(q), jnp.asarray(rows), jnp.asarray(valid), xs,
            mesh=mesh, k=k, metric=metric)
        np.testing.assert_allclose(np.asarray(got_d), np.asarray(ref_d),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(got_r), np.asarray(ref_r))


@pytest.mark.parametrize("b,m", [(4, 16), (2, 32)])
def test_sharded_fit_matches_single_device(rng, mesh, b, m):
    """fit_sharded at the PQ training shapes (several divisions of a
    narrow sub-vector width, rows padded to the mesh): per-device rounds
    + psum must reproduce the single-device fit."""
    from flechasdb_tpu.ops import kmeans
    from flechasdb_tpu.parallel.kmeans import fit_sharded

    n, k = 94, 6
    x = rng.standard_normal((b, n, m)).astype(np.float32)
    key = jax.random.key(5)

    single = kmeans.fit(jnp.asarray(x), k, key)
    pad = (-n) % mesh.devices.size
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, pad), (0, 0)))
    sharded = fit_sharded(xp, k, key, mesh=mesh, n_valid=n)

    np.testing.assert_allclose(np.asarray(sharded.centroids),
                               np.asarray(single.centroids),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(sharded.indices)[:, :n],
                                  np.asarray(single.indices))


def test_build_staged_matches_one_shot(rng):
    """build_staged (host-stepped Lloyd rounds — the Deep10M path) must
    reproduce the monolithic _build_step bit-for-bit given the same key,
    both with the training caps dormant and with both caps engaged."""
    from flechasdb_tpu import events as evmod
    from flechasdb_tpu.parallel.build import _build_step, build_staged

    n, m, p, d, c = 300, 16, 4, 2, 8
    x = rng.standard_normal((n, m)).astype(np.float32)

    for caps in [dict(), dict(pq_cap=128, coarse_cap=128)]:
        key = jax.random.key(21)
        seen = []
        staged = build_staged(x, p, d, c, key, events=seen.append, **caps)
        single = _build_step(jnp.asarray(x), key, p=p, d=d, c=c, **caps)
        np.testing.assert_allclose(
            np.asarray(staged.partition_centroids),
            np.asarray(single.partition_centroids), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(
            np.asarray(staged.partition_indices),
            np.asarray(single.partition_indices))
        np.testing.assert_array_equal(np.asarray(staged.codes),
                                      np.asarray(single.codes))
        assert any(isinstance(e, evmod.StartingSubvectorDivision)
                   for e in seen)


def test_build_codes_dtype_contract(rng):
    """Builds hand back the narrowest code dtype: uint8 when C <= 256
    (quarters the device->host fetch and the device residency), int32
    otherwise. Both the cap-engaged (chunked-encode) and small branches
    honor it, and shard_corpus widens back to int32 for the serving
    kernels (parallel/build.ShardedBuild docstring)."""
    from flechasdb_tpu.parallel.build import _build_step
    from flechasdb_tpu.parallel.mesh import shard_corpus

    n, m, p, d = 300, 16, 4, 2
    x = jnp.asarray(rng.standard_normal((n, m)).astype(np.float32))

    for caps in [dict(), dict(pq_cap=128, coarse_cap=128)]:
        built = _build_step(x, jax.random.key(5), p=p, d=d, c=8, **caps)
        assert built.codes.dtype == jnp.uint8, (caps, built.codes.dtype)
        assert built.partition_indices.dtype == jnp.uint16
        assert int(jnp.max(built.codes)) < 8

    wide = _build_step(x, jax.random.key(5), p=p, d=d, c=257)
    assert wide.codes.dtype == jnp.int32

    from flechasdb_tpu.parallel.build import _code_dtype, _pidx_dtype
    assert _code_dtype(256) == jnp.uint8 and _code_dtype(257) == jnp.int32
    assert _pidx_dtype(1 << 16) == jnp.uint16
    assert _pidx_dtype((1 << 16) + 1) == jnp.int32

    from flechasdb_tpu.parallel.mesh import corpus_mesh
    codes_s, _ = shard_corpus(corpus_mesh(), np.asarray(built.codes),
                              np.asarray(built.partition_indices))
    assert codes_s.dtype == jnp.int32


def test_sharded_build_fast_suffix(rng, mesh):
    """A ``_fast`` impl suffix must reach the sharded fit's rounds and
    still produce a sane build."""
    from flechasdb_tpu.parallel.build import _build_step

    n, m, p, d, c = 256, 128, 4, 2, 8
    x = rng.standard_normal((n, m)).astype(np.float32)
    key = jax.random.key(11)

    sharded = build_sharded(x, p, d, c, key, mesh=mesh, impl="xla_fast")
    single = _build_step(jnp.asarray(x), key, p=p, d=d, c=c)
    agree = (np.asarray(sharded.partition_indices)
             == np.asarray(single.partition_indices)).mean()
    assert agree >= 0.98, agree
    assert sharded.codes.dtype == jnp.uint8
    # bare "_fast" is the same numerics
    sharded2 = build_sharded(x, p, d, c, key, mesh=mesh, impl="_fast")
    assert (np.asarray(sharded2.partition_indices)
            == np.asarray(sharded.partition_indices)).mean() >= 0.98
