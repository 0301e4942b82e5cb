"""Linalg microbenchmarks — the reference's ``bin/benchmark.rs`` analogue.

The reference benchmarks its 16-way-unrolled kernels against naive loops on
10M-element vectors. The device equivalents are single fused XLA programs; this
compares them against single-threaded numpy on the host (the role the naive
loops play there), on the same 10M-element workload.

Usage: python benchmarks/micro.py — prints one JSON line per op.
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    import jax
    import jax.numpy as jnp

    n = 10_000_000
    rng = np.random.default_rng(0)
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    ad, bd = jnp.asarray(a), jnp.asarray(b)
    jax.block_until_ready(ad)

    ops = {
        "dot": (lambda: float(np.dot(a, b)),
                jax.jit(lambda x, y: jnp.dot(x, y,
                                             precision=jax.lax.Precision
                                             .HIGHEST))),
        "norm2": (lambda: float(np.linalg.norm(a)),
                  jax.jit(lambda x, y: jnp.linalg.norm(x))),
        "sum": (lambda: float(np.sum(a)),
                jax.jit(lambda x, y: jnp.sum(x))),
        "min": (lambda: float(np.min(a)),
                jax.jit(lambda x, y: jnp.min(x))),
        "max_abs": (lambda: float(np.max(np.abs(a))),
                    jax.jit(lambda x, y: jnp.max(jnp.abs(x)))),
        "scale_add": (lambda: np.sum(a * 2.5 + b),
                      jax.jit(lambda x, y: jnp.sum(x * 2.5 + y))),
    }

    for name, (host_fn, dev_fn) in ops.items():
        t0 = time.time()
        host_fn()
        host_ms = (time.time() - t0) * 1e3

        _ = np.asarray(dev_fn(ad, bd))          # compile
        reps = 50
        t0 = time.time()
        for _i in range(reps):
            r = dev_fn(ad, bd)
        _ = np.asarray(r)
        dev_ms = (time.time() - t0) / reps * 1e3
        print(json.dumps({
            "op": name, "n": n,
            "numpy_ms": round(host_ms, 3),
            "device_ms": round(dev_ms, 3),
            "speedup": round(host_ms / dev_ms, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
