"""Clustering engine tests: quality parity vs a NumPy oracle.

The reference only exercises k-means through its binaries; per SURVEY §4 we
add what it lacks — correctness vs brute force and quality (inertia) checks —
while pinning the reference's structural semantics (k==n shortcut, convergence
rule, determinism under an explicit key).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flechasdb_tpu.ops import kmeans
from flechasdb_tpu.ops.distance import assign_chunked, sqdist


def _blobs(rng, n_per, k, m, spread=0.05):
    centers = rng.standard_normal((k, m)).astype(np.float32) * 3
    pts = np.concatenate([
        c + spread * rng.standard_normal((n_per, m)).astype(np.float32)
        for c in centers
    ])
    perm = rng.permutation(len(pts))
    return pts[perm], centers


def _inertia(x, centroids, indices):
    return float(np.sum((x - np.asarray(centroids)[np.asarray(indices)]) ** 2))


def test_sqdist_matches_numpy(rng):
    x = rng.standard_normal((10, 7)).astype(np.float32)
    c = rng.standard_normal((4, 7)).astype(np.float32)
    expected = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    got = np.asarray(sqdist(jnp.asarray(x), jnp.asarray(c)))
    assert np.allclose(got, expected, rtol=1e-4, atol=1e-5)


def test_assign_chunked_matches_argmin(rng):
    x = rng.standard_normal((1, 100, 5)).astype(np.float32)
    c = rng.standard_normal((1, 7, 5)).astype(np.float32)
    idx, dmin = assign_chunked(jnp.asarray(x), jnp.asarray(c), k=7, chunk=16)
    expected = ((x[0][:, None] - c[0][None]) ** 2).sum(-1)
    assert np.array_equal(np.asarray(idx[0]), expected.argmin(1))
    assert np.allclose(np.asarray(dmin[0]), expected.min(1),
                       rtol=1e-4, atol=1e-5)


def test_recovers_well_separated_blobs(rng):
    x, centers = _blobs(rng, 50, 5, 8)
    res = kmeans.fit(jnp.asarray(x)[None], 5, jax.random.key(0))
    got = np.sort(np.asarray(res.centroids[0]), axis=0)
    # every true center recovered within the blob spread
    d = ((np.asarray(res.centroids[0])[:, None] - centers[None]) ** 2).sum(-1)
    assert (d.min(axis=0) < 0.1).all()
    # each point assigned with its blob-mates
    assert len(np.unique(np.asarray(res.indices[0]))) == 5
    assert got.shape == (5, 8)


def test_k_equals_n_shortcut(rng):
    x = rng.standard_normal((1, 6, 4)).astype(np.float32)
    res = kmeans.fit(jnp.asarray(x), 6, jax.random.key(1))
    assert np.array_equal(np.asarray(res.centroids), x)
    assert np.array_equal(np.asarray(res.indices[0]), np.arange(6))
    assert int(res.rounds[0]) == 0


def test_k_equals_one(rng):
    x = rng.standard_normal((1, 50, 4)).astype(np.float32)
    res = kmeans.fit(jnp.asarray(x), 1, jax.random.key(2))
    # single cluster converges to the global mean
    assert np.allclose(np.asarray(res.centroids[0, 0]), x[0].mean(0),
                       rtol=1e-4, atol=1e-5)
    assert (np.asarray(res.indices) == 0).all()


def test_fewer_vectors_than_k_raises(rng):
    x = jnp.asarray(rng.standard_normal((1, 3, 4)).astype(np.float32))
    with pytest.raises(ValueError):
        kmeans.fit(x, 5, jax.random.key(0))


def test_deterministic_under_key(rng):
    x = jnp.asarray(rng.standard_normal((1, 200, 6)).astype(np.float32))
    r1 = kmeans.fit(x, 8, jax.random.key(7))
    r2 = kmeans.fit(x, 8, jax.random.key(7))
    assert np.array_equal(np.asarray(r1.centroids), np.asarray(r2.centroids))
    assert np.array_equal(np.asarray(r1.indices), np.asarray(r2.indices))


def test_batched_divisions_independent(rng):
    """Batched PQ training must equal training each division separately."""
    x = rng.standard_normal((3, 120, 4)).astype(np.float32)
    key = jax.random.key(3)
    batched = kmeans.fit(jnp.asarray(x), 4, key)
    for d in range(3):
        # Same key trains the same batch row identically whether alone or
        # batched is NOT expected (keys fold differently); compare quality.
        solo = kmeans.fit(jnp.asarray(x[d:d + 1]), 4, key)
        ib = _inertia(x[d], batched.centroids[d], batched.indices[d])
        io_ = _inertia(x[d], solo.centroids[0], solo.indices[0])
        assert ib <= io_ * 1.5 + 1e-3


def test_quality_vs_numpy_lloyd(rng):
    """Inertia must match a plain NumPy Lloyd oracle within 10%."""
    x, _ = _blobs(rng, 40, 6, 10, spread=0.5)
    res = kmeans.fit(jnp.asarray(x)[None], 6, jax.random.key(11))
    ours = _inertia(x, res.centroids[0], res.indices[0])

    # oracle: numpy lloyd from random init, best of 3
    best = np.inf
    orng = np.random.default_rng(0)
    for _ in range(3):
        c = x[orng.choice(len(x), 6, replace=False)].copy()
        for _ in range(100):
            d = ((x[:, None] - c[None]) ** 2).sum(-1)
            a = d.argmin(1)
            newc = np.stack([
                x[a == j].mean(0) if (a == j).any() else c[j]
                for j in range(6)
            ])
            if np.allclose(newc, c):
                break
            c = newc
        best = min(best, _inertia(x, c, d.argmin(1)))
    assert ours <= best * 1.1


def test_identical_vectors_do_not_crash():
    # kmeans.rs:199 panics here; we degrade gracefully (documented).
    x = jnp.ones((1, 10, 4), jnp.float32)
    res = kmeans.fit(x, 3, jax.random.key(0))
    assert np.allclose(np.asarray(res.centroids), 1.0)


def test_events_path_matches_fast_path(rng):
    x = jnp.asarray(rng.standard_normal((2, 150, 6)).astype(np.float32))
    key = jax.random.key(9)
    fast = kmeans.fit(x, 5, key)
    seen = []
    obs = kmeans.fit_with_events(x, 5, key, seen.append)
    assert np.array_equal(np.asarray(fast.centroids),
                          np.asarray(obs.centroids))
    assert np.array_equal(np.asarray(fast.indices), np.asarray(obs.indices))
    kinds = [type(e).__name__ for e in seen]
    assert kinds[0] == "StartingCentroidInitialization"
    assert "FinishedCentroidUpdate" in kinds


def test_multi_round_stepping_matches_single(rng):
    """rounds_per_step fuses Lloyd rounds into one program; results and
    per-round gradients must be identical to stepping one at a time."""
    x = jnp.asarray(rng.standard_normal((3, 200, 6)).astype(np.float32))
    key = jax.random.key(4)
    one = kmeans.fit_with_events(x, 7, key, lambda e: None)
    grads = []

    def grab(e):
        if type(e).__name__ == "FinishedCentroidUpdate":
            grads.append(np.asarray(e.gradient))

    batched = kmeans.fit_with_events(x, 7, key, grab, rounds_per_step=6)
    assert np.array_equal(np.asarray(one.centroids),
                          np.asarray(batched.centroids))
    assert np.array_equal(np.asarray(one.indices),
                          np.asarray(batched.indices))
    assert np.array_equal(np.asarray(one.rounds), np.asarray(batched.rounds))
    # gradient history replays per round, not per program
    assert len(grads) >= int(np.asarray(one.rounds).max()) - 6
    import pytest

    with pytest.raises(ValueError):
        kmeans.fit_with_events(x, 7, key, lambda e: None, rounds_per_step=0)
    # max below the base step would silently SHRINK (or, at 0, collapse
    # to an empty scan + IndexError) — must raise like the 0-step case
    with pytest.raises(ValueError):
        kmeans.fit_with_events(x, 7, key, lambda e: None,
                               rounds_per_step=4, rounds_per_step_max=0)
    with pytest.raises(ValueError):
        kmeans.fit_with_events(x, 7, key, lambda e: None,
                               rounds_per_step=4, rounds_per_step_max=2)


def test_adaptive_stepping_matches_single(rng):
    """The doubling schedule (rounds_per_step_max) dispatches 2, 4, 8, 8…
    round programs; results must still be identical to one-at-a-time
    stepping — over-provisioned post-convergence rounds are skipped on
    device (lax.cond) and the grads fetch answers all-done with no extra
    program."""
    x = jnp.asarray(rng.standard_normal((3, 200, 6)).astype(np.float32))
    key = jax.random.key(4)
    one = kmeans.fit_with_events(x, 7, key, lambda e: None)
    adap = kmeans.fit_with_events(x, 7, key, lambda e: None,
                                  rounds_per_step=2, rounds_per_step_max=8)
    assert np.array_equal(np.asarray(one.centroids),
                          np.asarray(adap.centroids))
    assert np.array_equal(np.asarray(one.indices), np.asarray(adap.indices))
    assert np.array_equal(np.asarray(one.rounds), np.asarray(adap.rounds))
    assert np.array_equal(np.asarray(one.gradient),
                          np.asarray(adap.gradient))


def test_pq_subsample_training_parity():
    """Above PQ_TRAIN_CAP the build trains codebooks on a subsample and
    assigns codes chunked; quality must match full-corpus training and the
    chunked encoder must agree with a brute-force argmin."""
    import jax
    import jax.numpy as jnp

    from flechasdb_tpu.parallel.build import _build_step, _encode_chunked
    from flechasdb_tpu.utils.synth import gmm_corpus

    rng = np.random.default_rng(12)
    x = gmm_corpus(rng, 4096, 16, n_clusters=16, intrinsic=6)
    key = jax.random.key(7)

    full = _build_step(x, key, p=4, d=4, c=8)
    sub = _build_step(x, key, p=4, d=4, c=8, pq_cap=1024)

    # Chunked encode == brute-force argmin against the same codebooks.
    resid = jnp.asarray(x) - jnp.take(sub.partition_centroids,
                                      sub.partition_indices, axis=0)
    got = np.asarray(_encode_chunked(
        jnp.asarray(x), sub.partition_centroids, sub.partition_indices,
        sub.codebooks, chunk=300))
    r = np.asarray(resid).reshape(4096, 4, 4)
    cb = np.asarray(sub.codebooks)
    want = np.argmin(((r[:, :, None, :] - cb[None]) ** 2).sum(-1), axis=-1)
    np.testing.assert_array_equal(got, want)

    # Reconstruction error parity: subsample-trained codebooks encode the
    # corpus nearly as well as full-corpus-trained ones.
    def err(b):
        rr = np.asarray(x) - np.asarray(b.partition_centroids)[
            np.asarray(b.partition_indices)]
        rec = np.concatenate([
            np.asarray(b.codebooks)[di][np.asarray(b.codes)[:, di]]
            for di in range(4)], axis=1)
        return float(((rr - rec) ** 2).sum())

    assert err(sub) < 1.1 * err(full), (err(sub), err(full))


def test_train_cap_quality_and_host_stepped_agreement():
    """``train_cap``: Lloyd rounds on a subsample + one full assignment
    (the coarse-phase analogue of the PQ cap). Capped inertia must be
    close to uncapped, every vector must get a valid cluster, and the
    host-stepped ``fit_with_events`` must draw the SAME subsample as
    the one-program ``fit`` for the same key."""
    import jax

    from flechasdb_tpu.ops import kmeans
    from flechasdb_tpu.utils.synth import gmm_corpus

    rng = np.random.default_rng(5)
    x = jnp.asarray(gmm_corpus(rng, 6000, 16, n_clusters=8, intrinsic=5))
    key = jax.random.key(11)
    k = 8

    capped = kmeans.fit(x[None], k, key, train_cap=1500)
    full = kmeans.fit(x[None], k, key)

    def inertia(res):
        c = np.asarray(res.centroids[0])
        i = np.asarray(res.indices[0])
        return float(((np.asarray(x) - c[i]) ** 2).sum())

    assert capped.indices.shape == (1, 6000)
    assert set(np.unique(np.asarray(capped.indices))) <= set(range(k))
    assert inertia(capped) < 1.05 * inertia(full), (
        inertia(capped), inertia(full))

    stepped = kmeans.fit_with_events(x[None], k, key, lambda e: None,
                                     train_cap=1500, rounds_per_step=4)
    np.testing.assert_allclose(np.asarray(stepped.centroids),
                               np.asarray(capped.centroids),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(stepped.indices),
                                  np.asarray(capped.indices))

    with pytest.raises(ValueError, match="train_cap"):
        kmeans.fit(x[None], k, key, train_cap=4)


# --- the Lloyd round and fit at the build's vector widths ---------------------

@pytest.mark.parametrize("b,n,m,k", [
    (8, 600, 16, 32),     # PQ divisions, sub-vector width 16
    (4, 517, 32, 7),      # PQ divisions, width 32, N not a chunk multiple
    (1, 1000, 128, 24),   # coarse fit at SIFT width
])
def test_fused_round_matches_numpy(rng, b, n, m, k):
    """One Lloyd step (``_fused_round(impl="xla")``) against float64
    numpy: every assignment is the nearest centroid up to float32 ties,
    and the cluster sums/counts under the returned assignment are exact
    to f32 accumulation (rtol 1e-5)."""
    x = rng.standard_normal((b, n, m)).astype(np.float32)
    c = rng.standard_normal((b, k, m)).astype(np.float32)
    idx, sums, counts = kmeans._fused_round(jnp.asarray(x), jnp.asarray(c),
                                            k, "xla")
    idx, sums, counts = (np.asarray(a) for a in (idx, sums, counts))
    x64, c64 = x.astype(np.float64), c.astype(np.float64)
    for bb in range(b):
        dist = ((x64[bb][:, None] - c64[bb][None]) ** 2).sum(-1)
        chosen = dist[np.arange(n), idx[bb]]
        np.testing.assert_allclose(chosen, dist.min(1), rtol=1e-5)
        oh = (np.arange(k)[:, None] == idx[bb][None, :]).astype(np.float64)
        want = oh @ x64[bb]
        np.testing.assert_allclose(sums[bb], want, rtol=1e-5,
                                   atol=1e-5 * (oh @ np.abs(x64[bb])).max())
        np.testing.assert_array_equal(counts[bb], oh.sum(1))


@pytest.mark.parametrize("b,m,k", [(4, 16, 16), (2, 32, 8), (1, 128, 12)])
def test_fit_quality_matches_oracle(rng, b, m, k):
    """``fit`` reaches the numpy oracle's clustering quality on every
    batch entry at the build's vector widths."""
    from flechasdb_tpu import oracle

    x = np.stack([_blobs(rng, 40, k, m, spread=0.1)[0] for _ in range(b)])
    res = kmeans.fit(jnp.asarray(x), k, jax.random.key(2))
    for bb in range(b):
        ours = _inertia(x[bb], res.centroids[bb], res.indices[bb])
        theirs = min(
            oracle.inertia(x[bb], r.centroids, r.indices)
            for r in (oracle.kmeans(x[bb], k, np.random.default_rng(s))
                      for s in range(3)))
        assert ours <= 1.05 * theirs, (bb, ours, theirs)


@pytest.mark.parametrize("impl,precision", [
    (None, jax.lax.Precision.HIGH),
    ("xla", jax.lax.Precision.HIGH),
    ("_fast", jax.lax.Precision.DEFAULT),
    ("xla_fast", jax.lax.Precision.DEFAULT),
])
def test_impl_selects_assignment_precision(impl, precision):
    assert kmeans._assign_precision(impl) == precision


@pytest.mark.parametrize("impl", ["pallas", "pallas_grouped_fast", "gather"])
def test_unknown_impl_raises(rng, impl):
    x = jnp.asarray(rng.standard_normal((1, 40, 4)).astype(np.float32))
    with pytest.raises(ValueError, match="unknown impl"):
        kmeans.fit(x, 3, jax.random.key(0), impl=impl)
    with pytest.raises(ValueError, match="unknown impl"):
        kmeans.fit_with_events(x, 3, jax.random.key(0), lambda e: None,
                               impl=impl)


def test_fit_exhaustion_reassigns(rng):
    """When max_rounds exhausts before convergence the returned assignment
    must match the returned (post-final-update) centroids, as the
    reference's loop leaves it."""
    x = rng.standard_normal((300, 5)).astype(np.float32)  # no structure:
    xj = jnp.asarray(x)[None]                             # slow convergence
    res = kmeans.fit(xj, 6, jax.random.key(0), max_rounds=2)
    assert int(res.rounds[0]) == 2 and float(res.gradient[0]) > 1e-6
    expect, _ = assign_chunked(xj, res.centroids, k=6,
                               precision=jax.lax.Precision.HIGH)
    assert np.array_equal(np.asarray(res.indices), np.asarray(expect))
    # events path agrees
    ev = kmeans.fit_with_events(xj, 6, jax.random.key(0), lambda e: None,
                                max_rounds=2)
    assert np.array_equal(np.asarray(ev.indices), np.asarray(res.indices))
    # max_rounds=0 returns the seeding assignment unchanged
    r0 = kmeans.fit(xj, 6, jax.random.key(0), max_rounds=0)
    assert int(r0.rounds[0]) == 0


def test_fit_k1_and_tiny_n(rng):
    """Degenerate shapes through the round: k=1 (single cluster) and a
    small n must work at both numerics."""
    x = jnp.asarray(rng.standard_normal((2, 100, 5)).astype(np.float32))
    for impl in ("xla", "_fast"):
        r = kmeans.fit(x, 1, jax.random.key(0), impl=impl)
        assert np.array_equal(np.asarray(r.indices),
                              np.zeros((2, 100), np.int32))
        mean = np.asarray(x).mean(axis=1)
        assert np.allclose(np.asarray(r.centroids)[:, 0], mean,
                           rtol=1e-4, atol=1e-4)


def test_exhaustion_with_partially_converged_batch(rng):
    """One batch entry converges early (tight blobs), the other exhausts
    max_rounds (unstructured): the converged entry must keep its frozen
    pre-update assignment while the exhausted one is reassigned against
    its final centroids."""
    tight, _ = _blobs(rng, 50, 4, 5, spread=0.01)
    loose = rng.standard_normal((200, 5)).astype(np.float32)
    x = jnp.asarray(np.stack([tight[:200], loose]))
    res = kmeans.fit(x, 4, jax.random.key(1), max_rounds=3)
    ev = kmeans.fit_with_events(x, 4, jax.random.key(1), lambda e: None,
                                max_rounds=3, rounds_per_step=2)
    assert np.array_equal(np.asarray(res.indices), np.asarray(ev.indices))
    assert np.array_equal(np.asarray(res.centroids),
                          np.asarray(ev.centroids))
    # the unconverged entry's indices match assignment to final centroids
    for b in range(2):
        if float(res.gradient[b]) > 1e-6:  # exhausted
            expect, _ = assign_chunked(x[b:b + 1], res.centroids[b:b + 1],
                                       k=4,
                                       precision=jax.lax.Precision.HIGH)
            assert np.array_equal(np.asarray(res.indices[b]),
                                  np.asarray(expect[0]))


def test_fast_math_suffix_quality_and_routing(rng):
    """The ``_fast`` impl suffix (``Precision.DEFAULT`` on the assignment
    matmuls) must reach the round and land clustering of the same
    quality, and must not alias the default program in the jit cache."""
    x, _ = _blobs(rng, 50, 8, 6)
    xj = jnp.asarray(x)[None]
    key = jax.random.key(3)
    ref = kmeans.fit(xj, 8, key, impl="xla")
    i_ref = _inertia(x, ref.centroids[0], ref.indices[0])
    for impl in ["xla_fast", "_fast"]:
        got = kmeans.fit(xj, 8, key, impl=impl)
        i_got = _inertia(x, got.centroids[0], got.indices[0])
        assert abs(i_ref - i_got) <= 0.05 * max(i_ref, 1e-9), (impl, i_got)
        ev = kmeans.fit_with_events(xj, 8, key, lambda e: None, impl=impl)
        assert np.array_equal(np.asarray(ev.indices),
                              np.asarray(got.indices))

    with pytest.raises(ValueError, match="unknown impl"):
        kmeans.fit(xj, 8, key, impl="bogus_fast")
