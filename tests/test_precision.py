"""Matmul precision guards, read from the traced programs.

Query-path distances must be full float32: on GPUs with TF32 tensor
cores, ``DEFAULT`` and ``HIGH`` both allow TF32, so every query-path
``dot_general`` has to carry ``Precision.HIGHEST`` explicitly. Cluster
sums take no matmul at all; only the assignment passes train at reduced
precision.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

HIGHEST = jax.lax.Precision.HIGHEST


def _dot_precisions(jaxpr) -> list:
    """``precision`` of every ``dot_general`` in ``jaxpr`` and in every
    sub-jaxpr (jit, loops, conditionals, shard_map bodies)."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            found.extend(_dot_precisions(sub))
    return found


def _index(rng, n=64, m=16, p=4, d=4, c=8, b=3):
    f32 = np.float32
    return dict(
        q=jnp.asarray(rng.standard_normal((b, m)).astype(f32)),
        x=jnp.asarray(rng.standard_normal((n, m)).astype(f32)),
        centroids=jnp.asarray(rng.standard_normal((p, m)).astype(f32)),
        codebooks=jnp.asarray(rng.standard_normal((d, c, m // d)).astype(f32)),
        rotation=jnp.asarray(np.linalg.qr(
            rng.standard_normal((m, m)))[0].astype(f32)),
        codes=jnp.asarray(rng.integers(0, c, (n, d)).astype(np.int32)),
        pidx=jnp.asarray(rng.integers(0, p, n).astype(np.int32)),
        probed=jnp.asarray(rng.integers(0, p, (b, 2)).astype(np.int32)),
    )


def _coarse(a, metric):
    from flechasdb_tpu.ops.adc import coarse_scores
    return functools.partial(coarse_scores, metric=metric), (
        a["q"], a["centroids"])


def _probed_tables(a, metric):
    from flechasdb_tpu.ops.bucketed import probed_tables
    return functools.partial(probed_tables, metric=metric), (
        a["q"], a["centroids"], a["codebooks"], a["probed"], a["rotation"])


def _masked_scan(a, metric):
    from flechasdb_tpu.ops.adc import masked_scan_keys
    return (lambda *xs: masked_scan_keys(*xs, metric)), (
        a["q"], a["centroids"], a["codebooks"], a["codes"], a["pidx"],
        a["rotation"])


def _exact(a, metric):
    from flechasdb_tpu.ops.exact import exact_topk
    return functools.partial(exact_topk, k=5, chunk=16, metric=metric), (
        a["q"], a["x"])


def _rerank(a, metric):
    from flechasdb_tpu.build import _rerank_exact
    rows = jnp.zeros((a["q"].shape[0], 6), jnp.int32)
    return functools.partial(_rerank_exact, k=3, metric=metric), (
        a["q"], rows, jnp.ones(rows.shape, bool), a["x"])


def _flat(a, metric):
    from flechasdb_tpu.flat import _exact_keys_impl
    return functools.partial(_exact_keys_impl, metric=metric), (
        a["q"], a["x"])


def _sharded_exact(a, metric):
    from flechasdb_tpu.parallel import corpus_mesh, exact_sharded, shard_flat
    mesh = corpus_mesh(jax.devices("cpu")[:4])
    xs, n = shard_flat(mesh, np.asarray(a["x"]))
    return functools.partial(exact_sharded, mesh=mesh, k=3, n=n,
                             metric=metric), (a["q"], xs)


_CASES = [(f, m) for f in (_coarse, _probed_tables, _masked_scan, _exact,
                            _flat, _sharded_exact) for m in ("l2", "dot")]
_CASES.append((_rerank, "dot"))   # the L2 re-score is elementwise


@pytest.mark.parametrize("build,metric", _CASES,
                         ids=[f"{f.__name__.strip('_')}-{m}"
                              for f, m in _CASES])
def test_query_path_dots_are_highest(rng, build, metric):
    fn, args = build(_index(rng), metric)
    precisions = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precisions, "expected at least one dot_general"
    assert all(p == (HIGHEST, HIGHEST) for p in precisions), precisions


def test_cluster_sums_are_exact(rng):
    """Cluster sums take no matmul (nothing a reduced-precision pass
    could round), and match float64 to f32 accumulation error — with a
    chunk boundary inside the corpus and a shifted last chunk."""
    from flechasdb_tpu.ops.kmeans import _cluster_sums

    b, n, m, k = 2, 40_000, 8, 5
    x = rng.standard_normal((b, n, m)).astype(np.float32)
    idx = rng.integers(0, k, (b, n)).astype(np.int32)
    jaxpr = jax.make_jaxpr(
        functools.partial(_cluster_sums, k=k))(jnp.asarray(x),
                                               jnp.asarray(idx)).jaxpr
    assert _dot_precisions(jaxpr) == []

    sums, counts = _cluster_sums(jnp.asarray(x), jnp.asarray(idx), k)
    for bb in range(b):
        oh = (np.arange(k)[:, None] == idx[bb][None]).astype(np.float64)
        np.testing.assert_allclose(
            np.asarray(sums)[bb], oh @ x[bb].astype(np.float64), rtol=0,
            atol=1e-5 * (oh @ np.abs(x[bb]).astype(np.float64)).max())
        np.testing.assert_array_equal(np.asarray(counts)[bb], oh.sum(1))
