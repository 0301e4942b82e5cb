"""Synthetic corpora with descriptor-like statistics.

No-egress stand-ins for SIFT1M/GIST1M/Deep10M (BASELINE.json configs).
A single global low-rank subspace would be much easier than real
descriptor data. Real local-descriptor sets are
*clustered* (images share visual words) with low intrinsic dimensionality
inside each cluster — that structure is what both IVF (cluster axis) and PQ
(within-cluster manifold) exploit. This generator models it as a Gaussian
mixture on a shared low-rank manifold:

* ``n_clusters`` mixture components with Zipf-ish weights (natural corpora
  are imbalanced);
* component means drawn in a shared ``intrinsic``-dim latent space and
  pushed through one random linear map (descriptor dimensions are strongly
  correlated);
* per-component anisotropic noise at ``cluster_std`` scale plus a small
  full-dimensional noise floor so no direction is exactly degenerate.

Statistics tuned loosely to SIFT: for ``m=128, intrinsic=12,
n_clusters=256``, the nearest-neighbor distance contrast (d_far/d_near) and
per-dimension correlation spectrum land in the same regime as published
SIFT1M measurements — informative for PQ, non-trivial for IVF.
"""

from __future__ import annotations

import numpy as np


def gmm_corpus(rng: np.random.Generator, n: int, m: int, *,
               n_clusters: int = 256, intrinsic: int = 12,
               cluster_std: float = 0.35, noise: float = 0.05,
               chunk: int = 1 << 18) -> np.ndarray:
    """Clustered descriptor-like corpus ``[n, m]`` float32."""
    w = rng.standard_normal((intrinsic, m)).astype(np.float32)
    means_z = rng.standard_normal((n_clusters, intrinsic)).astype(np.float32)
    means = (means_z * 2.0) @ w                        # spread clusters out
    # Zipf-ish imbalance, normalized.
    weights = 1.0 / np.arange(1, n_clusters + 1) ** 0.7
    weights /= weights.sum()
    # Per-cluster anisotropic scales in latent space.
    scales = (cluster_std *
              rng.uniform(0.5, 1.5, (n_clusters, intrinsic))
              ).astype(np.float32)

    out = np.empty((n, m), np.float32)
    for i in range(0, n, chunk):
        nn = min(chunk, n - i)
        comp = rng.choice(n_clusters, size=nn, p=weights)
        z = rng.standard_normal((nn, intrinsic)).astype(np.float32)
        out[i:i + nn] = (means[comp] + (z * scales[comp]) @ w +
                         noise * rng.standard_normal((nn, m)
                                                     ).astype(np.float32))
    return out


def gmm_pair(rng: np.random.Generator, n: int, nq: int, m: int, **kw
             ) -> tuple[np.ndarray, np.ndarray]:
    """Corpus + held-out queries drawn from the SAME mixture (queries in
    real benchmarks come from the same distribution as the corpus)."""
    both = gmm_corpus(rng, n + nq, m, **kw)
    perm = rng.permutation(n + nq)
    return both[perm[:n]], both[perm[n:]]


def _gmm_params_device(key, m: int, n_clusters: int, intrinsic: int,
                       cluster_std: float):
    import jax
    import jax.numpy as jnp

    k_w, k_mz, k_sc = jax.random.split(key, 3)
    w = jax.random.normal(k_w, (intrinsic, m), jnp.float32)
    means = (jax.random.normal(k_mz, (n_clusters, intrinsic),
                               jnp.float32) * 2.0) @ w
    weights = 1.0 / jnp.arange(1, n_clusters + 1, dtype=jnp.float32) ** 0.7
    logw = jnp.log(weights / weights.sum())
    scales = cluster_std * jax.random.uniform(
        k_sc, (n_clusters, intrinsic), jnp.float32, 0.5, 1.5)
    return w, means, logw, scales


def _gmm_sample_device(key, params, n: int, m: int, noise: float,
                       chunk: int):
    import jax
    import jax.numpy as jnp

    w, means, logw, scales = params
    intrinsic = w.shape[0]
    chunk = min(chunk, n)
    k_body, k_tail = jax.random.split(key)

    def block(key, rows):
        k1, k2, k3 = jax.random.split(key, 3)
        comp = jax.random.categorical(k1, logw, shape=(rows,))
        z = jax.random.normal(k2, (rows, intrinsic), jnp.float32)
        return (jnp.take(means, comp, axis=0)
                + (z * jnp.take(scales, comp, axis=0)) @ w
                + noise * jax.random.normal(k3, (rows, m), jnp.float32))

    steps, tail = divmod(n, chunk)
    out = jnp.zeros((n, m), jnp.float32)

    def body(i, state):
        out, key = state
        key, kb = jax.random.split(key)
        out = jax.lax.dynamic_update_slice(
            out, block(kb, chunk), (i * chunk, 0))
        return out, key

    out, _ = jax.lax.fori_loop(0, steps, body, (out, k_body))
    if tail:
        out = jax.lax.dynamic_update_slice(
            out, block(k_tail, tail), (steps * chunk, 0))
    return out


def gmm_corpus_device(key, n: int, m: int, *,
                      n_clusters: int = 256, intrinsic: int = 12,
                      cluster_std: float = 0.35, noise: float = 0.05,
                      chunk: int = 1 << 19):
    """:func:`gmm_corpus` generated ON DEVICE (same mixture family, JAX
    PRNG instead of numpy's — statistically equivalent, not bit-equal).

    At 10M x 96 the host generator needs ~100 s of CPU plus a 3.84 GB
    ``device_put``; this program fills device memory directly.
    Generation is chunked with ``dynamic_update_slice`` so peak device
    memory stays ``out + O(chunk x m)``
    regardless of ``n``.
    """
    import jax
    import jax.numpy as jnp

    k_par, k_smp = jax.random.split(jnp.asarray(key))
    params = _gmm_params_device(k_par, m, n_clusters, intrinsic,
                                cluster_std)
    return _gmm_sample_device(k_smp, params, n, m, noise, chunk)


def gmm_pair_device(key, n: int, nq: int, m: int, *,
                    n_clusters: int = 256, intrinsic: int = 12,
                    cluster_std: float = 0.35, noise: float = 0.05,
                    chunk: int = 1 << 19):
    """Device-side corpus + queries from the SAME mixture.

    The two draws share the mixture parameters but use independent sample
    keys — equivalent to :func:`gmm_pair`'s held-out split without
    materializing or permuting ``n + nq`` rows.
    """
    import jax
    import jax.numpy as jnp

    k_par, k_c, k_q = jax.random.split(jnp.asarray(key), 3)
    params = _gmm_params_device(k_par, m, n_clusters, intrinsic,
                                cluster_std)
    return (_gmm_sample_device(k_c, params, n, m, noise, chunk),
            _gmm_sample_device(k_q, params, nq, m, noise, chunk))
