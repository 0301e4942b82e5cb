"""Kernel parity on the card, at the widths the system serves and builds.

Every test here is marked ``gpu``: it skips where JAX has no GPU, and
``chip_smoke.py`` runs the marker in its own process on the card (phase
1). Each kernel — as compiled for the card, never interpreted — is
compared with a float64 numpy reference, and each tolerance says why it
is what it is.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flechasdb_tpu.ops import kmeans
from flechasdb_tpu.ops.adc import coarse_scores
from flechasdb_tpu.ops.bucketed import bucket_scan, probed_tables

pytestmark = pytest.mark.gpu

#: Bucket length of a SIFT1M-shaped index (1M rows over P=1024 skewed
#: partitions, L = the largest partition rounded up to 128).
SIFT_L = 4096
#: One query batch of 1000 queries at nprobe=16.
CELLS = 1000 * 16


def _pack(raw: np.ndarray) -> np.ndarray:
    p, d, l = raw.shape
    packed = np.zeros((p, -(-d // 4), l), np.int32)
    for di in range(d):
        w, b = divmod(di, 4)
        packed[:, w] |= raw[:, di] << (8 * b)
    return packed


def _dots_without_highest(compiled_text: str) -> list:
    """Lines of compiled HLO that run a matmul (an XLA ``dot`` or a
    cuBLAS GEMM call) without ``HIGHEST`` operand precision — on this
    card any other precision may use TF32."""
    return [ln.strip()[:200] for ln in compiled_text.splitlines()
            if (" dot(" in ln or 'custom_call_target="__cublas' in ln)
            and "highest" not in ln.lower()]


@pytest.mark.parametrize("d", [8, 12])
def test_bucket_scan_on_card(gpu, d):
    """The scan as XLA compiles it for the card, against numpy, at a
    SIFT1M-shaped query batch. Tolerance rtol 1e-5 + atol 1e-5 ·
    max|table|: each slot is a gather plus a sum of D float32 values, so
    only the order of the sum can differ, and signed (dot-metric) table
    values can cancel."""
    rng = np.random.default_rng(d)
    p, c = 1024, 256
    raw = rng.integers(0, c, (p, d, SIFT_L)).astype(np.int32)
    codes = jnp.asarray(_pack(raw))
    ftab = rng.standard_normal((CELLS, d * c)).astype(np.float32)
    bidx = rng.integers(0, p, CELLS).astype(np.int32)
    lens = rng.integers(0, SIFT_L + 1, CELLS).astype(np.int32)
    lens[:3] = (0, SIFT_L, 1)
    args = (codes, jnp.asarray(ftab), jnp.asarray(bidx), jnp.asarray(lens))

    scan = jax.jit(functools.partial(bucket_scan, d=d))
    live = np.arange(SIFT_L)[None, :] < lens[:, None]
    cells = np.concatenate([[0, 1, 2], rng.choice(CELLS, 509, replace=False)])
    tab = ftab.astype(np.float64).reshape(CELLS, d, c)[cells]
    want = tab[np.arange(len(cells))[:, None, None],
               np.arange(d)[None, :, None], raw[bidx[cells]]].sum(axis=1)
    atol = 1e-5 * np.abs(ftab).max()
    got = np.asarray(scan(*args))
    assert got.shape == (CELLS, SIFT_L)
    np.testing.assert_array_equal(np.isinf(got), ~live)
    sel, m = got[cells], live[cells]
    np.testing.assert_allclose(sel[m], want[m], rtol=1e-5, atol=atol)


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("m,p,d", [(128, 1024, 8), (1536, 100, 12)])
def test_probe_tables_on_card(gpu, metric, m, p, d):
    """Coarse scores and probed ADC tables at SIFT (M=128) and the
    reference's 1536-d shape. Tolerance rtol 1e-5 + atol 1e-5·‖q‖·‖c‖:
    these are HIGHEST matmuls, so full float32 with no TF32, and the
    error of a float32 dot product scales with the operands' norms. The
    compiled programs must not leave a matmul at a lower precision."""
    rng = np.random.default_rng(m)
    c, b, nprobe = 256, 64, 16
    q = rng.standard_normal((b, m)).astype(np.float32)
    cents = rng.standard_normal((p, m)).astype(np.float32)
    cbs = rng.standard_normal((d, c, m // d)).astype(np.float32)
    coarse_fn = jax.jit(functools.partial(coarse_scores, metric=metric))
    tables_fn = jax.jit(lambda q, cents, cbs, probed, coarse: probed_tables(
        q, cents, cbs, probed, None, metric, coarse))
    coarse = coarse_fn(q, cents)
    probed = jax.lax.top_k(-coarse, nprobe)[1]
    tables = tables_fn(q, cents, cbs, probed, coarse)
    for fn, args in ((coarse_fn, (q, cents)),
                     (tables_fn, (q, cents, cbs, probed, coarse))):
        assert _dots_without_highest(fn.lower(*args).compile().as_text()) \
            == []

    q64, c64, cb64 = (a.astype(np.float64) for a in (q, cents, cbs))
    pr = np.asarray(probed)
    if metric == "dot":
        want_coarse = -(q64 @ c64.T)
        qc = np.einsum("bds,dcs->bdc", q64.reshape(b, d, -1), cb64)
        want_tab = (np.take_along_axis(want_coarse, pr, 1)[..., None, None]
                    / d - qc[:, None])
    else:
        want_coarse = ((q64[:, None] - c64[None]) ** 2).sum(-1)
        resid = (q64[:, None] - c64[pr]).reshape(b, nprobe, d, 1, -1)
        want_tab = ((resid - cb64[None, None]) ** 2).sum(-1)
    scale = np.linalg.norm(q64, axis=1).max() * max(
        np.linalg.norm(c64, axis=1).max(), np.linalg.norm(cb64, axis=2).max())
    np.testing.assert_allclose(np.asarray(coarse), want_coarse, rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(np.asarray(tables), want_tab, rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.fixture(scope="module")
def sift_corpus(gpu):
    from flechasdb_tpu.utils.synth import gmm_corpus_device
    return gmm_corpus_device(jax.random.key(0), 1_000_000, 128,
                             n_clusters=1024)


@pytest.mark.parametrize("b,m,k", [(1, 128, 1024), (8, 16, 256)],
                         ids=["coarse", "pq"])
def test_lloyd_round_on_card(sift_corpus, b, m, k):
    """One Lloyd round at the SIFT1M build's coarse shape (1M×128 → 1024
    centroids) and PQ shape (8 divisions of 1M×16 → 256 codes).

    Centroid sums: within 1e-5 of Σ|x| per element against float64 — the
    bound of float32 accumulation (relative to the sum itself it can be
    larger where members of opposite sign cancel). Assignments train at
    TF32 on this card, so they are compared on a 100k-row slice: every
    disagreement must be a near tie, its float64 distance gap within the
    TF32 error of the two distances (each ``‖x‖² + ‖c‖² − 2x·c`` with x·c
    off by at most 2⁻¹⁰·‖x‖·‖c‖)."""
    n = sift_corpus.shape[0]
    x = sift_corpus.reshape(n, b, m).transpose(1, 0, 2)
    rows = jax.random.choice(jax.random.key(1), n, (k,), replace=False)
    cents = x[:, rows]
    round_fn = jax.jit(functools.partial(kmeans._fused_round, k=k,
                                         impl="xla"))
    idx, sums, counts = (np.asarray(a) for a in round_fn(x, cents))

    xh = np.asarray(x, np.float64)
    ch = np.asarray(cents, np.float64)
    agree, worst = [], 0.0
    for bb in range(b):
        order = np.argsort(idx[bb], kind="stable")
        starts = np.searchsorted(idx[bb][order], np.arange(k))
        sel = np.concatenate([xh[bb][order], np.zeros((1, m))])
        want = np.add.reduceat(sel, starts, axis=0)
        want_abs = np.add.reduceat(np.abs(sel), starts, axis=0)
        size = np.diff(np.append(starts, n))
        want[size == 0] = want_abs[size == 0] = 0.0
        assert (np.abs(sums[bb] - want) <= 1e-5 * want_abs).all()
        np.testing.assert_array_equal(counts[bb], size)

        xs, ii = xh[bb][:100_000], idx[bb][:100_000]
        dist = (np.sum(xs * xs, 1)[:, None] + np.sum(ch[bb] ** 2, 1)[None]
                - 2.0 * xs @ ch[bb].T)
        best = dist.argmin(1)
        off = ii != best
        agree.append(1.0 - off.mean())
        if off.any():
            rr = np.flatnonzero(off)
            gap = dist[rr, ii[rr]] - dist[rr, best[rr]]
            cn = np.linalg.norm(ch[bb], axis=1)
            xn = np.linalg.norm(xs[rr], axis=1)
            bound = 2.0 * 2.0 ** -10 * xn * (cn[ii[rr]] + cn[best[rr]])
            assert (gap <= bound).all(), (gap / bound).max()
            worst = max(worst, float((gap / bound).max()))
    print(f"lloyd round {b}x{n}x{m} k={k}: assignment agreement "
          f"{min(agree):.6f} on a 100k-row slice; largest disagreement "
          f"gap {worst:.3f} of the TF32 bound")
