"""Host-utility parity tests (``src/nbest.rs``, ``src/distribution.rs``).

The distribution tests use a deterministic injected uniform sampler — the
reference's fake-``UniformSampler`` trick (``distribution.rs:124-206``) —
so sampling outputs are exactly assertable.
"""

import pytest

import flechasdb_tpu as fdb
from flechasdb_tpu.utils import NBestByKey, WeightedIndex, n_best_by_key


# --- nbest ------------------------------------------------------------------

def test_nbest_keeps_smallest():
    nb = NBestByKey(3, key=lambda x: x)
    for v in [9, 1, 8, 2, 7, 3, 6]:
        nb.push(v)
    assert sorted(nb) == [1, 2, 3]


def test_nbest_fewer_than_n():
    assert sorted(n_best_by_key([5, 4], 10, key=lambda x: x)) == [4, 5]


def test_nbest_with_key_function():
    items = [("a", 3.0), ("b", 1.0), ("c", 2.0), ("d", 0.5)]
    best = n_best_by_key(items, 2, key=lambda t: t[1])
    assert sorted(x[0] for x in best) == ["b", "d"]


def test_nbest_invalid_n():
    with pytest.raises(ValueError):
        NBestByKey(0, key=lambda x: x)


def test_nbest_duplicates_and_order_independence():
    a = sorted(n_best_by_key([3, 3, 1, 1, 2], 3, key=lambda x: x))
    b = sorted(n_best_by_key([1, 2, 3, 1, 3], 3, key=lambda x: x))
    assert a == b == [1, 1, 2]


# --- distribution -----------------------------------------------------------

def _stepper(values):
    """Deterministic 'uniform' yielding a fixed sequence of fractions of
    the requested range."""
    it = iter(values)

    def uniform(lo, hi):
        return lo + (hi - lo) * next(it)
    return uniform


def test_weighted_sample_deterministic():
    w = WeightedIndex([1.0, 2.0, 3.0, 4.0])      # cumsum: 1, 3, 6, 10
    u = _stepper([0.0, 0.05, 0.25, 0.55, 0.95])
    assert w.sample(u) == 0      # 0.0  -> first bucket
    assert w.sample(u) == 0      # 0.5  < 1
    assert w.sample(u) == 1      # 2.5  < 3
    assert w.sample(u) == 2      # 5.5  < 6
    assert w.sample(u) == 3      # 9.5  < 10


def test_weighted_sample_skips_zero_weights():
    w = WeightedIndex([0.0, 1.0, 0.0, 1.0, 0.0])
    u = _stepper([0.0, 0.99])
    assert w.sample(u) == 1
    # edge of range: must return the LAST non-zero index, never a zero one
    assert w.sample(u) == 3


def test_weighted_new_rejections():
    with pytest.raises(fdb.InvalidArgs):
        WeightedIndex([])
    with pytest.raises(fdb.InvalidArgs):
        WeightedIndex([1.0, -0.5])
    with pytest.raises(fdb.InvalidArgs):
        WeightedIndex([0.0, 0.0])


def test_weighted_update():
    w = WeightedIndex([1.0, 1.0, 1.0])
    w.update([(0, 0.0), (2, 4.0)])
    assert w.get_weight(0) == 0.0
    assert w.get_weight(2) == 4.0
    assert w.total_weight == pytest.approx(5.0)
    u = _stepper([0.1])
    assert w.sample(u) == 1      # 0.5 < 1 and index 0 has zero weight


def test_weighted_update_failure_is_atomic():
    w = WeightedIndex([1.0, 2.0])
    with pytest.raises(fdb.InvalidArgs):
        w.update([(0, 5.0), (7, 1.0)])           # OOB after a valid entry
    assert w.get_weight(0) == 1.0                # unchanged
    with pytest.raises(fdb.InvalidArgs):
        w.update([(0, 0.0), (1, 0.0)])           # total becomes zero
    assert w.total_weight == pytest.approx(3.0)
    with pytest.raises(fdb.InvalidArgs):
        w.update([(1, -1.0)])
    assert w.get_weight(1) == 2.0


# --- profiling ----------------------------------------------------------------

def test_profiler_trace_writes_dump(tmp_path):
    import jax.numpy as jnp
    import numpy as np
    from flechasdb_tpu.utils import annotate, trace

    with trace(tmp_path):
        with annotate("unit-test-phase"):
            _ = np.asarray(jnp.arange(8).sum())
    dumped = list(tmp_path.rglob("*"))
    assert any(p.is_file() for p in dumped), "no profiler output written"


# --- synthetic data ------------------------------------------------------------

def test_gmm_device_generator_matches_host_statistics():
    """Device GMM (utils/synth.gmm_corpus_device) must look like the host
    generator: same shape/dtype, comparable spread, clustered structure,
    and chunking (incl. a non-dividing tail) must not distort the data."""
    import jax
    import numpy as np
    from flechasdb_tpu.utils.synth import (
        gmm_corpus, gmm_corpus_device, gmm_pair_device)

    x = np.asarray(gmm_corpus_device(
        jax.random.key(0), 4000, 24, n_clusters=32, intrinsic=6,
        chunk=1700))  # 2 full chunks + 600-row tail
    h = gmm_corpus(np.random.default_rng(0), 4000, 24,
                   n_clusters=32, intrinsic=6)
    assert x.shape == (4000, 24) and x.dtype == np.float32
    assert np.isfinite(x).all()
    assert 0.5 < x.std() / h.std() < 2.0
    # tail rows must be drawn from the same mixture, not zeros/garbage
    assert 0.5 < x[3400:].std() / x[:3400].std() < 2.0

    c, q = gmm_pair_device(jax.random.key(1), 3000, 64, 24,
                           n_clusters=32, intrinsic=6, chunk=999)
    c, q = np.asarray(c), np.asarray(q)
    assert c.shape == (3000, 24) and q.shape == (64, 24)
    # queries come from the SAME mixture: their NN distance inside the
    # corpus must look like corpus self-NN distance (same parameters),
    # which fails if the pair helper re-drew the mixture.
    dq = ((q[:, None, :] - c[None, :1000, :]) ** 2).sum(-1).min(1)
    dc = ((c[:64, None, :] - c[None, :1000, :]) ** 2).sum(-1)
    dc = np.partition(dc, 1, axis=1)[:, 1]
    ratio = np.median(dq) / np.median(dc)
    assert 0.2 < ratio < 5.0


# --- compilation cache --------------------------------------------------------

@pytest.mark.parametrize("env_dir", ["/cache/from/env", None])
def test_compilation_cache_dir(monkeypatch, env_dir):
    """``JAX_COMPILATION_CACHE_DIR`` wins and nothing is set in code;
    without it the cache goes to the fixed in-checkout directory."""
    import jax

    from flechasdb_tpu.utils import cache

    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.__setitem__(name, value))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    got = cache.enable_compilation_cache()
    if env_dir is None:
        assert got == cache.DEFAULT_DIR
        assert updates["jax_compilation_cache_dir"] == cache.DEFAULT_DIR
        assert cache.DEFAULT_DIR.endswith(".jax_cache")
    else:
        assert got == env_dir and updates == {}
