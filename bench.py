"""Headline benchmark: the reference's build-random workload on one GPU.

Reference numbers (BASELINE.md, README.md:136-140): building the IVF-PQ
database for 100,000 × 1536-d f32 random vectors (P=100, D=12, C=256) takes
**906.5 s** on an M1 Pro CPU.

Prints exactly ONE JSON line on stdout:
    {"metric": ..., "value": N, "unit": "s", "vs_baseline": N}
``vs_baseline`` is the speedup factor (reference_seconds / ours).
Diagnostics go to stderr. The corpus is generated and normalized on the
device, and the JAX persistent compilation cache is enabled, so a second
process skips XLA compilation. Exits non-zero when JAX finds no GPU.
"""

import json
import sys
import time

import numpy as np

N, M, P, D, C = 100_000, 1536, 100, 12, 256
BASELINE_S = 906.5


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    import jax

    from flechasdb_tpu.utils.cache import enable_compilation_cache

    cache_dir = enable_compilation_cache()

    import jax.numpy as jnp

    from flechasdb_tpu.parallel.build import _build_step

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform!r}")
    log(f"device: {dev.device_kind} x{len(jax.devices())}")

    @jax.jit
    def _prepare(key):
        v = jax.random.normal(key, (N, M), dtype=jnp.float32)
        return v / jnp.linalg.norm(v, axis=1, keepdims=True)

    t0 = time.time()
    xd = jax.block_until_ready(_prepare(jax.random.key(42)))
    prep_s = time.time() - t0
    log(f"prepare {N}x{M} on device (incl. RNG compile): {prep_s:.2f}s "
        f"(reference host prep 0.912s)")

    # Warm-up compile on identical shapes. With the persistent cache this is
    # a disk hit after the first-ever run; cold it is one XLA compile
    # (production builds amortize it — the reference baseline likewise
    # excludes `cargo build`).
    t0 = time.time()
    jax.block_until_ready(_build_step(xd, jax.random.key(1), p=P, d=D, c=C))
    compile_s = time.time() - t0
    log(f"compile+first build: {compile_s:.2f}s "
        f"(persistent cache at {cache_dir})")

    # Median of 3 warm builds: robust to one bad sample while keeping the
    # run short.
    samples = []
    for i in range(3):
        t0 = time.time()
        built = _build_step(xd, jax.random.key(42), p=P, d=D, c=C)
        pops = np.unique(np.asarray(built.partition_indices)).size
        samples.append(time.time() - t0)
        log(f"build[{i}]: {samples[-1]:.3f}s  ({pops}/{P} partitions "
            f"populated; reference 906.5s)")
    build_s = sorted(samples)[1]
    log(f"build median-of-3: {build_s:.3f}s  (samples: "
        + ", ".join(f"{s:.3f}" for s in samples) + ")")

    # Secondary diagnostics: warm batched query latency (k=10, nprobe=5)
    # through the production serving path (bucketed layout).
    from flechasdb_tpu.ops.bucketed import bucketize, query_bucketed
    q = xd[:64]
    buckets = bucketize(np.asarray(built.codes),
                        np.asarray(built.partition_indices), P)
    dists, rows, _ = query_bucketed(
        q, built.partition_centroids, built.codebooks, buckets,
        k=10, nprobe=5)
    jax.block_until_ready(dists)
    t0 = time.time()
    reps = 20
    for _ in range(reps):
        dists, rows, _ = query_bucketed(
            q, built.partition_centroids, built.codebooks, buckets,
            k=10, nprobe=5)
    jax.block_until_ready(dists)  # dispatches pipeline; one wait at the end
    per_batch = (time.time() - t0) / reps
    log(f"warm query batch=64: {per_batch * 1e3:.2f} ms "
        f"({64 / per_batch:.0f} qps; "
        f"reference warm single query 1.48 ms)")

    # Single-query latency: batch=1 through the
    # production bucketed path — the number a serverless user comparing
    # against the reference README's 1.48 ms warm / 7.80 ms cold looks
    # for. "Cold" here is first dispatch of the compiled program with a
    # fresh query (no device-side caches warm); each rep fences.
    q1 = xd[:1]
    d1, _, _ = query_bucketed(q1, built.partition_centroids,
                              built.codebooks, buckets, k=10, nprobe=5)
    cold_1 = None
    t0 = time.time()
    _ = np.asarray(d1)
    cold_1 = time.time() - t0  # first-result fetch after warm compile
    lat = []
    for i in range(20):
        qi = xd[i:i + 1]
        t0 = time.time()
        di, _, _ = query_bucketed(qi, built.partition_centroids,
                                  built.codebooks, buckets, k=10, nprobe=5)
        _ = np.asarray(di)      # fence per query: true request latency
        lat.append(time.time() - t0)
    lat.sort()
    log(f"warm query batch=1: p50 {lat[len(lat)//2]*1e3:.2f} ms, "
        f"min {lat[0]*1e3:.2f} ms (reference warm 1.48 ms); "
        f"first-dispatch fetch {cold_1*1e3:.2f} ms "
        f"(reference cold 7.80 ms)")

    print(json.dumps({
        "metric": f"build {N//1000}k x {M} IVF-PQ (P={P}, D={D}, C={C})",
        "value": round(build_s, 3),
        "unit": "s",
        "vs_baseline": round(BASELINE_S / build_s, 1),
    }))


if __name__ == "__main__":
    main()
