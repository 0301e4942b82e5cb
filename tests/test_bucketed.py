"""Pruned bucketed query must agree exactly with the masked full scan."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flechasdb_tpu.ops.adc import query_masked_scan
from flechasdb_tpu.ops.bucketed import (bucket_scan, bucketize,
                                        query_bucketed, range_bucketed)


def _random_index(rng, n=700, m=64, p=9, d=4, c=16):
    centroids = rng.standard_normal((p, m)).astype(np.float32)
    codebooks = rng.standard_normal((d, c, m // d)).astype(np.float32)
    codes = rng.integers(0, c, (n, d)).astype(np.int32)
    pidx = rng.integers(0, p, n).astype(np.int32)
    return centroids, codebooks, codes, pidx


def test_bucketize_roundtrip(rng):
    _, _, codes, pidx = _random_index(rng)
    b = bucketize(codes, pidx, 9)
    assert b.codes.shape[2] % 128 == 0
    lengths = np.asarray(b.lengths)
    np.testing.assert_array_equal(lengths, np.bincount(pidx, minlength=9))
    rows = np.asarray(b.rows)
    # every corpus row appears exactly once, in its own partition's bucket
    flat = rows[rows >= 0]
    assert sorted(flat.tolist()) == list(range(len(codes)))
    for pi in range(9):
        members = rows[pi][rows[pi] >= 0]
        assert np.all(pidx[members] == pi)
        np.testing.assert_array_equal(
            np.asarray(b.codes)[pi, :, :len(members)].T, codes[members])


@pytest.mark.parametrize("nprobe", [1, 3, 9])
def test_bucketed_matches_masked_scan(rng, nprobe):
    centroids, codebooks, codes, pidx = _random_index(rng)
    q = rng.standard_normal((6, centroids.shape[1])).astype(np.float32)
    buckets = bucketize(codes, pidx, centroids.shape[0])

    ref_d, ref_r, ref_p = query_masked_scan(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        jnp.asarray(codes), jnp.asarray(pidx), k=10, nprobe=nprobe)
    got_d, got_r, got_p = query_bucketed(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        buckets, k=10, nprobe=nprobe)

    np.testing.assert_array_equal(np.asarray(got_p), np.asarray(ref_p))
    np.testing.assert_allclose(np.asarray(got_d), np.asarray(ref_d),
                               rtol=1e-5, atol=1e-5)
    # row agreement modulo exact-distance ties
    rd, gd = np.asarray(ref_d), np.asarray(got_d)
    rr, gr = np.asarray(ref_r), np.asarray(got_r)
    for b in range(len(q)):
        diff = rr[b] != gr[b]
        if diff.any():
            np.testing.assert_allclose(rd[b][diff], gd[b][diff], rtol=1e-6)


def test_bucketed_small_partition_padding(rng):
    """Fewer reachable vectors than k ⇒ +inf tail, no pad rows returned."""
    centroids, codebooks, codes, pidx = _random_index(rng, n=40, p=8)
    q = rng.standard_normal((2, centroids.shape[1])).astype(np.float32)
    buckets = bucketize(codes, pidx, 8)
    d, r, _ = query_bucketed(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        buckets, k=30, nprobe=1)
    d, r = np.asarray(d), np.asarray(r)
    for b in range(2):
        finite = np.isfinite(d[b])
        assert np.all(r[b][finite] >= 0)
        assert np.all(r[b][finite] < 40)
        assert finite.sum() < 30  # one partition can't hold 30 of 40 rows


@pytest.mark.parametrize("d", [4, 5, 8, 2])
def test_packed_buckets_match_unpacked(rng, d):
    """Packed buckets (4 byte codes per word) must produce identical
    query results, including D not a multiple of 4."""
    m = d * 8
    centroids, codebooks, codes, pidx = _random_index(
        rng, n=500, m=m, p=7, d=d, c=200)
    q = rng.standard_normal((5, m)).astype(np.float32)
    plain = bucketize(codes, pidx, 7)
    packed = bucketize(codes, pidx, 7, pack=True)
    assert packed.codes.shape[1] == -(-d // 4)
    args = (jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks))
    ref = query_bucketed(*args, plain, k=10, nprobe=3)
    got = query_bucketed(*args, packed, k=10, nprobe=3)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))


def test_bucketize_pack_validation(rng):
    codes = np.full((10, 4), 300, np.int32)   # codes >= 256: unpackable
    pidx = np.zeros(10, np.int32)
    with pytest.raises(ValueError):
        bucketize(codes, pidx, 2, pack=True)
    b = bucketize(codes, pidx, 2, pack="auto")   # falls back silently
    assert b.codes.shape[1] == 4


def _pack_codes(bcodes, d):
    p, _, l = bcodes.shape
    packed = np.zeros((p, -(-d // 4), l), np.int32)
    for di in range(d):
        w, bb = divmod(di, 4)
        packed[:, w] |= bcodes[:, di] << (8 * bb)
    return packed


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("pack,d,c", [
    (pack, d, 256) for pack in (False, True) for d in (2, 4, 5, 8, 12)
] + [(False, 5, 100), (True, 12, 100)])
def test_bucket_scan_matches_numpy(rng, pack, d, c, masked):
    """The bucket scan against a float64 numpy lookup-sum: packed and
    unpacked buckets, D not a multiple of 4, C not a power of two, and
    ragged fill lengths including empty and full cells (or none: every
    slot scored)."""
    p, l, g = 7, 384, 13
    bcodes = rng.integers(0, c, (p, d, l)).astype(np.int32)
    resident = _pack_codes(bcodes, d) if pack else bcodes
    ftab = rng.standard_normal((g, d * c)).astype(np.float32)
    bidx = rng.integers(0, p, (g,)).astype(np.int32)
    lens = rng.integers(0, l + 1, (g,)).astype(np.int32)
    lens[0], lens[1] = 0, l
    if not masked:
        lens[:] = l
    got = np.asarray(bucket_scan(
        jnp.asarray(resident), jnp.asarray(ftab), jnp.asarray(bidx),
        jnp.asarray(lens) if masked else None, d=d))
    tab = ftab.astype(np.float64).reshape(g, d, c)
    codes = bcodes[bidx]                                  # [G, D, L]
    want = tab[np.arange(g)[:, None, None], np.arange(d)[None, :, None],
               codes].sum(axis=1)
    live = np.arange(l)[None, :] < lens[:, None]
    assert got.shape == (g, l)
    np.testing.assert_array_equal(np.isinf(got), ~live)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5,
                               atol=1e-5 * np.abs(tab).max())


def _numpy_ivfpq(q, centroids, codebooks, codes, pidx, *, k, nprobe,
                 metric):
    """Float64 IVF-PQ reference: probe the ``nprobe`` best partitions,
    score every member by ADC over its own partition, keep ``k``.
    Returns per-query ``(rows, keys, probed)``."""
    q, cents, cbs = (np.asarray(a, np.float64)
                     for a in (q, centroids, codebooks))
    d, c, sub = cbs.shape
    recon = cbs[np.arange(d)[None, :], codes].reshape(len(codes), -1)
    out = []
    for qb in q:
        if metric == "dot":
            coarse = -(cents @ qb)
        else:
            coarse = ((cents - qb) ** 2).sum(-1)
        probed = np.argsort(coarse, kind="stable")[:nprobe]
        rows = np.flatnonzero(np.isin(pidx, probed))
        if metric == "dot":
            keys = -((cents[pidx[rows]] + recon[rows]) @ qb)
        else:
            keys = ((qb - cents[pidx[rows]] - recon[rows]) ** 2).sum(-1)
        order = np.argsort(keys, kind="stable")[:k]
        out.append((rows[order], keys[order], probed))
    return out


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("nprobe", [1, 9])
def test_query_bucketed_matches_numpy_ivfpq(rng, metric, pack, nprobe):
    """query_bucketed against a float64 numpy IVF-PQ reference, with k
    larger than the candidate count at nprobe=1 (the +inf tail)."""
    centroids, codebooks, codes, pidx = _random_index(rng, n=300, p=9,
                                                      c=64)
    q = rng.standard_normal((5, centroids.shape[1])).astype(np.float32)
    k = 60 if nprobe == 1 else 10
    buckets = bucketize(codes, pidx, 9, pack=pack)
    d_got, r_got, p_got = (np.asarray(a) for a in query_bucketed(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        buckets, k=k, nprobe=nprobe, metric=metric))
    ref = _numpy_ivfpq(q, centroids, codebooks, codes, pidx, k=k,
                       nprobe=nprobe, metric=metric)
    for b, (rows, keys, probed) in enumerate(ref):
        np.testing.assert_array_equal(np.sort(p_got[b]), np.sort(probed))
        n_live = len(rows)
        assert np.isinf(d_got[b, n_live:]).all()
        np.testing.assert_allclose(d_got[b, :n_live], keys, rtol=1e-5,
                                   atol=1e-5 * np.abs(keys).max())
        # same rows, up to the order of exact ties
        assert set(r_got[b, :n_live].tolist()) == set(rows.tolist())


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("pack", [False, True])
def test_range_bucketed_matches_numpy_ivfpq(rng, metric, pack):
    """range_bucketed returns every probed row's ADC key (float64 numpy
    reference), with pad slots and rows filtered out by ``row_mask`` at
    ``+inf`` / ``-1``."""
    centroids, codebooks, codes, pidx = _random_index(rng, n=300, p=9,
                                                      c=64)
    q = rng.standard_normal((4, centroids.shape[1])).astype(np.float32)
    mask = rng.random(len(codes)) < 0.7
    keys, rows, probed = (np.asarray(a) for a in range_bucketed(
        jnp.asarray(q), jnp.asarray(centroids), jnp.asarray(codebooks),
        bucketize(codes, pidx, 9, pack=pack), None, jnp.asarray(mask),
        nprobe=3, metric=metric))
    ref = _numpy_ivfpq(q, centroids, codebooks, codes, pidx, k=len(codes),
                       nprobe=3, metric=metric)
    for b, (want_rows, want_keys, want_probed) in enumerate(ref):
        np.testing.assert_array_equal(np.sort(probed[b]),
                                      np.sort(want_probed))
        keep = mask[want_rows]
        live = rows[b] >= 0
        assert np.array_equal(np.isfinite(keys[b]), live)
        got = dict(zip(rows[b][live].tolist(), keys[b][live].tolist()))
        assert sorted(got) == sorted(want_rows[keep].tolist())
        np.testing.assert_allclose(
            [got[r] for r in want_rows[keep]], want_keys[keep], rtol=1e-5,
            atol=1e-5 * np.abs(want_keys).max())


@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_bucket_scan_lowers_to_plain_xla(platform):
    """The scan is one XLA program on every platform: a gather and a
    sum, with no custom call (no hand-written kernel, no per-platform
    branch)."""
    args = (jnp.zeros((3, 2, 512), jnp.int32), jnp.ones((4, 8 * 16)),
            jnp.zeros((4,), jnp.int32), jnp.ones((4,), jnp.int32))
    fn = jax.jit(functools.partial(bucket_scan, d=8))
    txt = fn.trace(*args).lower(lowering_platforms=(platform,)).as_text()
    assert re.findall(r"custom_call @([\w$.]+)", txt) == []
    assert "stablehlo.gather" in txt
