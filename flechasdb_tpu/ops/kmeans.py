"""Batched k-means++ / Lloyd's clustering on the accelerator.

Reference semantics (``src/kmeans.rs``), re-architected as batched matmuls:

* Seeding is k-means++ (``kmeans.rs:142-229``): first centroid uniform, each
  subsequent centroid sampled with probability proportional to the running
  minimum squared distance, which becomes ``jax.random.categorical`` over
  ``log(w)`` with on-device weight updates inside a ``lax.fori_loop``.
* Lloyd's loop (``kmeans.rs:104-139``): at most ``R = 100`` rounds; each round
  recomputes centroids as cluster means, measures the *normalized gradient*
  ``max_k ||c_old - c_new|| / max_k ||c_new||`` and stops when it drops below
  epsilon (1e-6 for f32, ``kmeans.rs:24-28``) — the convergence check happens
  *after* the centroid update and *before* reassignment, exactly as in
  ``kmeans.rs:125-137``, so returned assignments always predate the final
  centroid update for converged runs.
* The whole thing carries a leading batch axis ``B``: product quantization
  trains all ``D`` division codebooks simultaneously in one compiled program
  (the reference loops divisions sequentially, ``db/build.rs:110-118``).
  Per-batch convergence is tracked with a ``done`` mask; converged batch
  entries freeze while the rest continue.

Deliberate divergences from the reference (documented per SURVEY §7):

* Empty clusters keep their previous centroid instead of panicking
  (``kmeans.rs:259`` asserts non-empty).
* If every remaining seeding weight is zero (all vectors identical), sampling
  degenerates to index 0 instead of erroring (``kmeans.rs:199`` TODO).
* RNG is JAX's counter-based PRNG, threaded explicitly — runs are exactly
  reproducible for a given key, but never bit-identical to Rust's
  ``thread_rng``; parity tests compare clustering quality, not bits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .distance import assign_chunked, sqdist_one

#: Maximum Lloyd's rounds (``kmeans.rs:114``).
MAX_ROUNDS = 100

#: Default convergence epsilon for f32 (``kmeans.rs:24-28``).
DEFAULT_EPSILON = 1e-6

#: Matmul precision of the TRAINING assignment scans (k-means++ seeding,
#: Lloyd assignment, PQ encoding). These only rank centroids, so they may
#: run on reduced-precision matmul units: on GPUs with TF32 tensor cores
#: both HIGH and DEFAULT allow TF32 (about 10 mantissa bits); near-ties
#: within that rounding may assign differently than in f32. Cluster sums
#: take no matmul (:func:`_cluster_sums`) and query-path distances
#: (ops/adc.py, ops/bucketed.py) stay HIGHEST.
_PRECISION = jax.lax.Precision.HIGH


class KMeansResult(NamedTuple):
    """Clustering output — the ``Codebook`` analogue (``kmeans.rs:62-68``).

    ``centroids: [B, K, M]``; ``indices: [B, N] int32`` cluster assignment per
    input vector; ``rounds: [B] int32`` Lloyd rounds executed; ``gradient:
    [B]`` last normalized centroid displacement.
    """
    centroids: jax.Array
    indices: jax.Array
    rounds: jax.Array
    gradient: jax.Array


def _take_rows(x: jax.Array, idx: jax.Array) -> jax.Array:
    """Gathers one row per batch: ``x [B, N, M]``, ``idx [B]`` → ``[B, M]``."""
    return jnp.take_along_axis(x, idx[:, None, None], axis=1)[:, 0]


def plusplus_init(x: jax.Array, k: int,
                  key: jax.Array) -> tuple[jax.Array, jax.Array]:
    """k-means++ seeding (``kmeans.rs:142-229``).

    ``x: [B, N, M]`` → ``(centroids [B, K, M], indices [B, N] int32)`` where
    ``indices`` tracks the nearest *chosen-so-far* centroid, mirroring the
    incremental index updates at ``kmeans.rs:209-219``.
    """
    b, n, m = x.shape
    k0, k1 = jax.random.split(key)
    batch = jnp.arange(b)

    ci0 = jax.random.randint(k0, (b,), 0, n)
    c0 = _take_rows(x, ci0)
    centroids = jnp.zeros((b, k, m), x.dtype).at[:, 0].set(c0)
    indices = jnp.zeros((b, n), jnp.int32)
    if k == 1:
        return centroids, indices

    w = sqdist_one(x, c0, precision=_PRECISION)            # running min squared distance [B, N]
    w = w.at[batch, ci0].set(0.0)    # chosen points are excluded (weight 0)

    def step(i, state):
        centroids, w, indices = state
        ki = jax.random.fold_in(k1, i)
        # sample ∝ w; log(0) = -inf excludes already-chosen points
        ci = jax.random.categorical(ki, jnp.log(w))
        c = _take_rows(x, ci)
        centroids = centroids.at[:, i].set(c)
        d = sqdist_one(x, c, precision=_PRECISION)
        closer = d < w               # strict <, as in kmeans.rs:215
        w = jnp.where(closer, d, w).at[batch, ci].set(0.0)
        indices = jnp.where(closer, i, indices).at[batch, ci].set(i)
        return centroids, w, indices

    centroids, _, indices = jax.lax.fori_loop(
        1, k, step, (centroids, w, indices))
    return centroids, indices


def _cluster_sums(x: jax.Array, indices: jax.Array,
                  k: int) -> tuple[jax.Array, jax.Array]:
    """Per-cluster member sums and sizes, exact in float32.
    ``(sums [B, K, M] f32, counts [B, K])``.

    A segment sum (scatter-add) over row chunks: no matmul, so no
    reduced-precision pass can round the corpus values before they are
    summed. Each chunk's partial sums are formed separately and then
    added, which bounds how many rows one float32 accumulator takes in
    (the order of a GPU's atomic adds is not fixed, so builds agree in
    quality, not in the last bits).
    """
    b, n, m = x.shape
    # Chunks come from dynamic_slice in a fori_loop — never a padded copy
    # of x (that would be a second corpus-sized array on the device).
    chunk = min(n, 1 << 15)
    steps = -(-n // chunk)
    offset = (jnp.arange(b, dtype=jnp.int32) * (k + 1))[:, None]

    def body(i, carry):
        sums, counts = carry
        # Last chunk shifts back to stay in bounds; rows already covered by
        # the previous chunk go to the dropped segment k instead.
        start = jnp.minimum(i * chunk, jnp.maximum(n - chunk, 0))
        xi = jax.lax.dynamic_slice_in_dim(x, start, chunk, axis=1)
        ii = jax.lax.dynamic_slice_in_dim(indices, start, chunk, axis=1)
        fresh = (start + jnp.arange(chunk)) >= i * chunk       # [chunk]
        seg = (jnp.where(fresh[None, :], ii, k) + offset).reshape(-1)
        sums = sums + jax.ops.segment_sum(
            xi.reshape(b * chunk, m).astype(jnp.float32), seg,
            num_segments=b * (k + 1)).reshape(b, k + 1, m)
        counts = counts + jax.ops.segment_sum(
            jnp.ones(b * chunk, jnp.float32), seg,
            num_segments=b * (k + 1)).reshape(b, k + 1)
        return sums, counts

    init = (jnp.zeros((b, k + 1, m), jnp.float32),
            jnp.zeros((b, k + 1), jnp.float32))
    sums, counts = jax.lax.fori_loop(0, steps, body, init)
    return sums[:, :k], counts[:, :k]


def _means_grad(sums: jax.Array, counts: jax.Array, old: jax.Array,
                dtype) -> tuple[jax.Array, jax.Array]:
    """Centroid means + convergence gradient (``kmeans.rs:232-276``).

    Empty clusters keep their old centroid; ``gradient =
    max_k ||Δc|| / max_k ||c_new||`` (``kmeans.rs:261-275``).
    """
    empty = counts == 0
    mean = sums / jnp.where(empty, 1.0, counts)[..., None]
    new = jnp.where(empty[..., None], old, mean.astype(dtype))

    dist = jnp.linalg.norm(old - new, axis=-1)     # [B, K]
    norm = jnp.linalg.norm(new, axis=-1)           # [B, K]
    max_norm = jnp.max(norm, axis=-1)
    grad = jnp.where(max_norm > 0, jnp.max(dist, axis=-1) / max_norm, 0.0)
    return new, grad


def _assign_precision(impl: str | None) -> jax.lax.Precision:
    """Matmul precision of the assignment passes selected by ``impl``.

    ``None`` or ``"xla"`` train at :data:`_PRECISION`; a ``_fast`` suffix
    (``"_fast"``, ``"xla_fast"``) drops them to ``Precision.DEFAULT``.
    ``impl`` is static in every jit cache of the stack, so the two
    numerics never alias one compiled program. Anything else raises.
    """
    if impl in (None, "xla"):
        return _PRECISION
    if impl in ("_fast", "xla_fast"):
        return jax.lax.Precision.DEFAULT
    raise ValueError(f"unknown impl: {impl!r}")


def _fused_round(x: jax.Array, centroids: jax.Array, k: int,
                 impl: str | None,
                 ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Assignment against ``centroids`` plus cluster sums/counts under that
    fresh assignment — the whole data-touching part of one Lloyd round:
    a chunked distance + argmin pass, then a chunked cluster-sum pass.
    ``impl`` as in :func:`_assign_precision`.
    """
    indices = _assign_only(x, centroids, k, impl)
    sums, counts = _cluster_sums(x, indices, k)
    return indices, sums, counts


def _assign_only(x: jax.Array, centroids: jax.Array, k: int,
                 impl: str | None) -> jax.Array:
    """Assignment with the same tie-breaking as :func:`_fused_round`."""
    return assign_chunked(x, centroids, k=k,
                          precision=_assign_precision(impl))[0]


def _seed_cap(k: int) -> int:
    """Max rows used for k-means++ seeding.

    Seeding is inherently serial (k dependent steps, ``kmeans.rs:201-221``);
    over the full corpus each step touches all N rows, and at GIST1M scale
    (k=1024, N=1M) the 1024 small dependent kernels dominated the whole
    build. Seeding on a subsample and then running one full assignment pass
    keeps init quality (Lloyd's refinement washes out sampling noise) while
    making seeding O(k · cap). Documented divergence from the reference,
    which seeds on all points.
    """
    return max(4096, 32 * k)


def _subsampled_init(x: jax.Array, k: int, key: jax.Array, *,
                     need_indices: bool = True,
                     ) -> tuple[jax.Array, jax.Array]:
    b, n, m = x.shape
    cap = _seed_cap(k)
    if n <= cap:
        return plusplus_init(x, k, key)
    k_pick, k_seed = jax.random.split(key)
    # With-replacement draws: duplicates have zero k-means++ weight once
    # chosen, so they are never picked twice; avoids an O(N log N) shuffle.
    rows = jax.random.randint(k_pick, (cap,), 0, n)
    centroids, _ = plusplus_init(x[:, rows], k, k_seed)
    if not need_indices:
        # The first Lloyd round recomputes the assignment from these same
        # centroids anyway — skip the full-corpus pass (a whole corpus read
        # at Deep10M scale) when the caller will run at least one round.
        return centroids, jnp.zeros((b, n), jnp.int32)
    indices, _ = assign_chunked(x, centroids, k=k, precision=_PRECISION)
    return centroids, indices


@functools.partial(jax.jit,
                   static_argnames=("k", "epsilon", "max_rounds", "impl",
                                    "train_cap"))
def fit(x: jax.Array, k: int, key: jax.Array, *,
        epsilon: float = DEFAULT_EPSILON,
        max_rounds: int = MAX_ROUNDS,
        impl: str | None = None,
        train_cap: int | None = None) -> KMeansResult:
    """k-means++ seeding followed by Lloyd's loop, fully on device.

    ``x: [B, N, M]``; ``k`` is static. ``N == k`` short-circuits to
    one-vector-per-cluster (``kmeans.rs:158-169``).

    Each round runs assignment-then-update against the entering centroids
    (:func:`_fused_round`); the reference's
    stop-before-reassignment rule (``kmeans.rs:130-136``) is preserved:
    returned assignments always predate the final centroid update for
    converged runs. ``impl`` as in :func:`_assign_precision`.

    ``train_cap``: when set and ``N > train_cap``, the Lloyd loop trains on
    a uniform ``train_cap``-row subsample (with-replacement draws, as the
    PQ cap in ``..parallel.build``) and the full corpus gets ONE final
    assignment pass against the trained centroids. Round cost becomes
    O(cap·K·M) instead of O(N·K·M) — centroid quality saturates at a few
    hundred rows per centroid while the reference's full-corpus rounds
    (``kmeans.rs:104-139``) scale linearly. Documented divergence: under
    an engaged cap, returned assignments are *post*-final-update (the
    stop-before-reassignment rule applies to the subsample's trajectory).
    """
    b, n, m = x.shape
    _assign_precision(impl)  # validates impl
    if n < k:
        raise ValueError(f"vs has fewer vectors than k: {n} < {k}")
    if n == k:
        idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (b, n))
        return KMeansResult(x, idx, jnp.zeros((b,), jnp.int32),
                            jnp.zeros((b,), jnp.float32))
    if train_cap is not None and train_cap > 0 and n > train_cap:
        if train_cap < k:
            raise ValueError(
                f"train_cap is smaller than k: {train_cap} < {k}")
        k_rows, k_sub = jax.random.split(key)
        rows = jax.random.randint(k_rows, (train_cap,), 0, n)
        sub = fit(x[:, rows], k, k_sub, epsilon=epsilon,
                  max_rounds=max_rounds, impl=impl)
        idx = _assign_only(x, sub.centroids, k, impl)
        return KMeansResult(sub.centroids, idx, sub.rounds, sub.gradient)

    centroids, indices = _subsampled_init(x, k, key,
                                          need_indices=max_rounds == 0)
    if max_rounds == 0:
        return KMeansResult(centroids, indices, jnp.zeros((b,), jnp.int32),
                            jnp.full((b,), jnp.inf, jnp.float32))

    return lloyd_loop(
        centroids, indices, x.dtype, epsilon=epsilon, max_rounds=max_rounds,
        round_fn=lambda c: _fused_round(x, c, k, impl),
        assign_fn=lambda c: _assign_only(x, c, k, impl))


def lloyd_loop(centroids, indices, dtype, *, epsilon, max_rounds,
               round_fn, assign_fn, post_update=None) -> KMeansResult:
    """The Lloyd driver shared by :func:`fit` and the sharded fit.

    Owns the convergence/freeze semantics — the trickiest parity surface
    (``kmeans.rs:114-137``) — in ONE place; callers inject the round
    kernel (``round_fn(centroids) -> (indices, sums, counts)``), the
    epilogue assignment (``assign_fn(centroids) -> indices``), and an
    optional ``post_update`` centroid hook (the sharded fit re-pins
    replication there). Freeze rules: batches converged before a round
    keep centroids AND indices; a batch converging IN a round keeps the
    assignment against the PRE-update centroids, as the reference
    requires; batches that exhaust ``max_rounds`` unconverged carry an
    assignment predating the final update, so one last ``assign_fn`` runs
    for them (skipped entirely when everything converged).
    """
    b = centroids.shape[0]

    class S(NamedTuple):
        centroids: jax.Array
        indices: jax.Array
        done: jax.Array
        rounds: jax.Array
        gradient: jax.Array
        r: jax.Array

    def cond(s: S):
        return (s.r < max_rounds) & ~jnp.all(s.done)

    def body(s: S):
        idx_f, sums, counts = round_fn(s.centroids)
        new_c, grad = _means_grad(sums, counts, s.centroids, dtype)
        newly_done = grad < epsilon
        centroids = jnp.where(s.done[:, None, None], s.centroids, new_c)
        if post_update is not None:
            centroids = post_update(centroids)
        indices = jnp.where(s.done[:, None], s.indices, idx_f)
        return S(
            centroids=centroids,
            indices=indices,
            done=s.done | newly_done,
            rounds=s.rounds + (~s.done).astype(jnp.int32),
            gradient=jnp.where(s.done, s.gradient, grad),
            r=s.r + 1,
        )

    s0 = S(centroids, indices,
           jnp.zeros((b,), bool), jnp.zeros((b,), jnp.int32),
           jnp.full((b,), jnp.inf, jnp.float32), jnp.asarray(0, jnp.int32))
    s = jax.lax.while_loop(cond, body, s0)
    final_idx = jax.lax.cond(
        jnp.all(s.done),
        lambda: s.indices,
        lambda: jnp.where(s.done[:, None], s.indices,
                          assign_fn(s.centroids)))
    return KMeansResult(s.centroids, final_idx, s.rounds, s.gradient)


def fit_with_events(x: jax.Array, k: int, key: jax.Array, handler, *,
                    epsilon: float = DEFAULT_EPSILON,
                    max_rounds: int = MAX_ROUNDS,
                    rounds_per_step: int = 1,
                    rounds_per_step_max: int | None = None,
                    impl: str | None = None,
                    train_cap: int | None = None) -> KMeansResult:
    """Observable variant of :func:`fit` (``kmeans.rs:104-139``).

    Runs the Lloyd loop from the host, emitting :mod:`..events` cluster events
    each round (use :func:`fit` for peak throughput when no events or host
    stepping are needed). Results are identical to :func:`fit` for the same
    key.

    ``rounds_per_step``: Lloyd rounds fused into each device program
    (``lax.scan``; per-batch ``done`` masks freeze converged entries, so
    results are identical to stepping one round at a time). Raising it
    amortizes the per-program host round-trip (dispatch plus the
    gradient fetch the events need). Rounds
    dispatched past all-batches-converged cost ~nothing: the scanned
    round body skips its corpus pass under a ``lax.cond`` once every
    batch entry is done (:func:`_scan_rounds_jit`). Per-round events
    still fire, replayed from the returned gradient history.

    ``rounds_per_step_max``: when set, the per-program round count DOUBLES
    after each program (``rounds_per_step``, ``2·rounds_per_step``, … up
    to this cap). Early programs stay short — most fits converge in tens
    of rounds, and short programs bound the all-done skip-round waste —
    while a slow-converging fit amortizes toward one round-trip per
    ``rounds_per_step_max`` rounds instead of one per ``rounds_per_step``.

    ``train_cap`` as in :func:`fit`: train on a subsample, one final
    full-corpus assignment pass.
    """
    from .. import events as ev

    if rounds_per_step < 1:
        raise ValueError(
            f"rounds_per_step must be positive: {rounds_per_step}")
    if rounds_per_step_max is not None and \
            rounds_per_step_max < rounds_per_step:
        # 0 would collapse cur_steps to an empty scan after the first
        # program (IndexError on the grads fetch); anything below
        # rounds_per_step would silently SHRINK the step instead of
        # growing it — both are caller bugs, mirror the check above.
        raise ValueError(
            f"rounds_per_step_max ({rounds_per_step_max}) must be >= "
            f"rounds_per_step ({rounds_per_step})")
    b, n, m = x.shape
    _assign_precision(impl)  # validates impl
    if n < k:
        raise ValueError(f"vs has fewer vectors than k: {n} < {k}")
    if n == k:
        idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (b, n))
        return KMeansResult(jnp.asarray(x), idx, jnp.zeros((b,), jnp.int32),
                            jnp.zeros((b,), jnp.float32))
    if train_cap is not None and train_cap > 0 and n > train_cap:
        if train_cap < k:
            raise ValueError(
                f"train_cap is smaller than k: {train_cap} < {k}")
        k_rows, k_sub = jax.random.split(key)   # same stream as fit's
        xs = _gather_training_rows(x, k_rows, cap=train_cap)
        res = fit_with_events(xs, k, k_sub, handler, epsilon=epsilon,
                              max_rounds=max_rounds,
                              rounds_per_step=rounds_per_step,
                              rounds_per_step_max=rounds_per_step_max,
                              impl=impl)
        idx = _assign_jit(x, res.centroids, k=k, impl=impl)
        return KMeansResult(res.centroids, idx, res.rounds, res.gradient)

    handler(ev.StartingCentroidInitialization())
    centroids, indices = _init_jit(x, k, key, skip_indices=max_rounds > 0)
    # The event must not fire before seeding actually ran.
    jax.block_until_ready(centroids)
    handler(ev.FinishedCentroidInitialization())
    if max_rounds == 0:
        # Same contract as fit(): the init assignment IS the result — the
        # while-else epilogue below must not re-assign it.
        return KMeansResult(centroids, indices, jnp.zeros((b,), jnp.int32),
                            jnp.full((b,), jnp.inf, jnp.float32))

    done = jnp.zeros((b,), bool)
    rounds = jnp.zeros((b,), jnp.int32)
    gradient = jnp.full((b,), jnp.inf, jnp.float32)
    r = 0
    cur_steps = rounds_per_step
    all_done = False
    while r < max_rounds:
        steps = min(cur_steps, max_rounds - r)
        centroids, indices, done, rounds, gradient, grads = _scan_rounds_jit(
            x, centroids, indices, done, rounds, gradient, k=k,
            epsilon=epsilon, steps=steps, impl=impl)
        grads_host = jax.device_get(grads)          # [steps, B]
        # A batch entry is done iff its FROZEN gradient is sub-epsilon
        # (gradient freezes at the converging round's value; unconverged
        # entries carry their last raw grad >= epsilon) — so the grads
        # fetch already answers all-done, with no extra device program.
        all_done = bool((grads_host[-1] < epsilon).all())
        for i in range(steps):
            gh = grads_host[i]
            handler(ev.StartingCentroidUpdate(r + i))
            handler(ev.FinishedCentroidUpdate(
                r + i, gh if b > 1 else float(gh[0])))
            converged_by_now = bool((grads_host[:i + 1] < epsilon)
                                    .any(axis=0).all())
            if converged_by_now:
                break
            handler(ev.StartingCentroidReassignment(r + i))
            handler(ev.FinishedCentroidReassignment(r + i))
        if all_done:
            break
        r += steps
        if rounds_per_step_max is not None:
            cur_steps = min(cur_steps * 2, rounds_per_step_max)
    else:
        # max_rounds exhausted with unconverged batches: their carried
        # assignment predates the final centroid update; reassign, as in
        # :func:`fit`'s epilogue.
        if not all_done:
            fresh = _assign_jit(x, centroids, k=k, impl=impl)
            indices = jnp.where(done[:, None], indices, fresh)
    return KMeansResult(centroids, indices, rounds, gradient)


@functools.partial(jax.jit, static_argnames=("k", "skip_indices"))
def _init_jit(x, k, key, *, skip_indices=False):
    return _subsampled_init(x, k, key, need_indices=not skip_indices)


@functools.partial(jax.jit, static_argnames=("cap",))
def _gather_training_rows(x, key, *, cap):
    """Uniform with-replacement row draw for :func:`fit`'s ``train_cap``
    (same draw as the jitted path, so host-stepped and one-program fits
    see identical subsamples for the same key)."""
    rows = jax.random.randint(key, (cap,), 0, x.shape[1])
    return x[:, rows]


@functools.partial(jax.jit, static_argnames=("k", "impl"))
def _assign_jit(x, centroids, *, k, impl):
    return _assign_only(x, centroids, k, impl)


@functools.partial(jax.jit, static_argnames=("k", "epsilon", "steps", "impl"))
def _scan_rounds_jit(x, centroids, indices, done, rounds, gradient,
                     *, k, epsilon, steps, impl):
    """``steps`` Lloyd rounds in one program (``lax.scan`` over the
    :func:`_round_body`); identical results to ``steps`` host-stepped
    rounds — ``done`` freezes converged batch entries either way. Returns
    the per-round FROZEN gradient history ``[steps, B]`` for event replay
    (a batch that converged in an earlier program reports its frozen
    sub-epsilon gradient, matching ``KMeansResult.gradient``, not a raw
    recomputation). Rounds after EVERY batch entry converged skip their
    corpus pass under a ``lax.cond`` (the frozen state is returned
    unchanged either way — the skip only avoids computing results that
    the ``done`` masks would discard), so callers may over-provision
    ``steps`` cheaply (``rounds_per_step_max`` doubling)."""

    def run_round(state):
        c, i, d, r, g = state
        c, i, d, r, g, _raw = _round_body(x, c, i, d, r, g, k, epsilon,
                                          impl)
        return (c, i, d, r, g)

    def body(state, _):
        state = jax.lax.cond(jnp.all(state[2]),      # state[2] = done [B]
                             lambda s: s, run_round, state)
        return state, state[4]                       # state[4] = gradient

    (centroids, indices, done, rounds, gradient), grads = jax.lax.scan(
        body, (centroids, indices, done, rounds, gradient), None,
        length=steps)
    return centroids, indices, done, rounds, gradient, grads


def _round_body(x, centroids, indices, done, rounds, gradient, k, epsilon,
                impl=None):
    idx_f, sums, counts = _fused_round(x, centroids, k, impl)
    new_c, grad = _means_grad(sums, counts, centroids, x.dtype)
    newly_done = grad < epsilon
    centroids = jnp.where(done[:, None, None], centroids, new_c)
    # Freshly converged entries keep idx_f — the assignment against the
    # PRE-update centroids (kmeans.rs:130-136).
    indices = jnp.where(done[:, None], indices, idx_f)
    rounds = rounds + (~done).astype(jnp.int32)
    gradient = jnp.where(done, gradient, grad)
    return centroids, indices, done | newly_done, rounds, gradient, grad
