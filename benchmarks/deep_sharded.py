"""Deep10M-class sharded configuration (BASELINE.json scale-up config).

Sharded Deep10M (10M × 96) splits the PQ codes across the cards of a
mesh, each scanning its share of the probed buckets, with a k-best merge
across the mesh. (The CPU mesh validates the program, not its speed —
virtual CPU devices execute GSPMD programs orders of magnitude slower
than cards.) This script executes the EXACT multi-device program — sharded build +
shard_map query with local top-k and all_gather merge — on the virtual
8-device CPU mesh at a scaled-down shape, verifying the sharded results
against single-device execution. On real hardware only the mesh handle
changes (``corpus_mesh(jax.devices())``).

Usage: python benchmarks/deep_sharded.py [--n 200000]
"""

import argparse
import json
import os
import sys
import time

# Virtual 8-device CPU mesh (must precede any jax import).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=5_000)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from flechasdb_tpu.ops.bucketed import bucketize, query_bucketed
    from flechasdb_tpu.parallel import (
        build_sharded, corpus_mesh, query_sharded, shard_corpus)

    try:
        jax.config.update("jax_default_device", jax.devices("cpu")[0])
    except RuntimeError:
        pass
    devices = jax.devices("cpu")
    mesh = corpus_mesh(devices)
    n, m, p, d, c = args.n, 96, 128, 12, 256   # Deep* shape, scaled down
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, m)).astype(np.float32)
    q = rng.standard_normal((64, m)).astype(np.float32)

    t0 = time.time()
    built = build_sharded(x, p, d, c, jax.random.key(0), mesh=mesh)
    pidx = np.asarray(built.partition_indices)
    print(json.dumps({
        "config": "deep-sharded", "mesh": len(devices),
        "metric": f"sharded build {n}x{m} P={p} D={d} C={c} (CPU mesh)",
        "value": round(time.time() - t0, 2), "unit": "s"}), flush=True)

    codes_s, pidx_s = shard_corpus(mesh, np.asarray(built.codes), pidx)
    t0 = time.time()
    sd, sr, _ = query_sharded(
        jnp.asarray(q), built.partition_centroids, built.codebooks,
        codes_s, pidx_s, mesh=mesh, k=10, nprobe=10)
    sd = np.asarray(sd)
    print(json.dumps({
        "config": "deep-sharded", "mesh": len(devices),
        "metric": "sharded query batch 64, nprobe=10 (CPU mesh)",
        "value": round((time.time() - t0) * 1e3, 1), "unit": "ms"}),
        flush=True)

    # Cross-check against single-device bucketed execution.
    buckets = bucketize(np.asarray(built.codes), pidx, p)
    rd, rr, _ = query_bucketed(
        jnp.asarray(q), built.partition_centroids, built.codebooks,
        buckets, k=10, nprobe=10)
    ok = np.allclose(sd, np.asarray(rd), rtol=1e-5, atol=1e-5)
    print(json.dumps({
        "config": "deep-sharded",
        "metric": "sharded == single-device distances",
        "value": bool(ok)}), flush=True)
    assert ok


if __name__ == "__main__":
    main()
