"""Serialize / load / stored-query latency at the reference's shape.

Covers the BASELINE.md rows bench.py doesn't: serialize 0.143 s, load
(root manifest only) 0.142 ms, sync query cold 7.80 ms / warm 1.48 ms,
attribute fetch ×10 cold 3.39 ms (all reference numbers, M1 Pro SSD,
``/root/reference/README.md:140,203-216``).

Workload: the same 100k × 1536 DB as bench.py (P=100, D=12, C=256),
built through the public ``DatabaseBuilder`` so the saved tree is the
production artifact layout (partitions/codebooks/attribute logs/root,
``serialize.py``). The corpus is generated on device and fetched once
(untimed — the reference's corpus also pre-exists in RAM when its
serialize timer starts).

Usage: python benchmarks/serialize_bench.py [--n 100000]
Emits one JSON line per measurement.
"""

import argparse
import asyncio
import json
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def log(obj):
    print(json.dumps(obj), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=1536)
    args = ap.parse_args()
    n, m, p, d, c = args.n, args.m, 100, 12, 256

    import jax
    import jax.numpy as jnp

    from flechasdb_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    import flechasdb_tpu as fdb
    from flechasdb_tpu.asyncdb.save import save_database as async_save

    t0 = time.time()
    jax.block_until_ready(jnp.ones((8, 8)) @ jnp.ones((8, 8)))
    log({"metric": "backend warm-up (tiny op)",
         "value": round(time.time() - t0, 1), "unit": "s"})

    @jax.jit
    def _prepare(key):
        v = jax.random.normal(key, (n, m), dtype=jnp.float32)
        return v / jnp.linalg.norm(v, axis=1, keepdims=True)

    t0 = time.time()
    xd = _prepare(jax.random.key(42))
    x = np.asarray(xd)                             # one full fetch, untimed
    log({"metric": "prepare + fetch corpus to host",
         "value": round(time.time() - t0, 1), "unit": "s"})

    # Build from the device-resident corpus (as bench.py does): handing the
    # builder the host copy would re-pay a 614 MB device_put, which is
    # transfer, not build work.
    t0 = time.time()
    db = (fdb.DatabaseBuilder(xd).with_partitions(p).with_divisions(d)
          .with_clusters(c).with_seed(7).build())
    log({"metric": f"build {n//1000}k x {m} via DatabaseBuilder",
         "value": round(time.time() - t0, 2), "unit": "s"})
    for i in range(1000):                          # attribute load for logs
        db.set_attribute_at(i, ("tag", f"v{i}"))

    # --- serialize (sync), reference 0.143 s -----------------------------
    with tempfile.TemporaryDirectory() as td:
        t0 = time.time()
        root = fdb.save_database(db, fdb.LocalFileSystem(td))
        save_s = time.time() - t0
        log({"metric": "save_database (sync, local SSD)",
             "value": round(save_s, 3), "unit": "s",
             "reference_s": 0.143})

        # --- load root manifest only, reference 0.142 ms -----------------
        lats = []
        for _ in range(20):
            t0 = time.time()
            sdb = fdb.load_database(fdb.LocalFileSystem(td), f"{root}.binpb")
            lats.append(time.time() - t0)
        lats.sort()
        log({"metric": "load_database (root manifest only), p50",
             "value": round(lats[10] * 1e3, 3), "unit": "ms",
             "reference_ms": 0.142})

        # --- sync stored query: cold (lazy loads) then warm --------------
        # p50 over reps (the 1-vCPU bench host is noisy; single-shot rows
        # previously swung 2x run to run). "Cold" reloads the DB each rep
        # so every query pays the lazy partition reads — page-cache-warm,
        # like the reference's own cold row (measured right after save).
        q = x[0]
        cold_lats, attr_lats = [], []
        for _ in range(15):
            si = fdb.load_database(fdb.LocalFileSystem(td), f"{root}.binpb")
            t0 = time.time()
            res = si.query(q, k=10, nprobe=5)
            cold_lats.append(time.time() - t0)
            t0 = time.time()
            got = [r.get_attribute("tag") for r in res]
            attr_lats.append(time.time() - t0)
            assert sum(g is not None for g in got) >= 0
        sdb.query(q, k=10, nprobe=5)               # warm sdb's caches
        warm_lats = []
        for _ in range(30):
            t0 = time.time()
            res = sdb.query(q, k=10, nprobe=5)
            warm_lats.append(time.time() - t0)
        cold_lats.sort(), warm_lats.sort(), attr_lats.sort()
        log({"metric": "stored sync query cold (lazy loads, host path), p50",
             "value": round(cold_lats[len(cold_lats) // 2] * 1e3, 2),
             "unit": "ms", "reference_ms": 7.80})
        log({"metric": "stored sync query warm (host path), p50",
             "value": round(warm_lats[len(warm_lats) // 2] * 1e3, 2),
             "unit": "ms", "reference_ms": 1.48,
             "min_ms": round(warm_lats[0] * 1e3, 2)})
        log({"metric": "attribute fetch x10 results (cold logs), p50",
             "value": round(attr_lats[len(attr_lats) // 2] * 1e3, 2),
             "unit": "ms", "reference_ms": 3.39})

    # --- async concurrent save + async read path -------------------------
    # Reference async rows: load 0.171 ms, query cold 8.04 ms / warm
    # 0.789 ms, attribute fetch x10 1.94 ms (README.md:291-304).
    with tempfile.TemporaryDirectory() as td:
        t0 = time.time()
        root2 = asyncio.run(async_save(db, fdb.LocalFileSystem(td)))
        log({"metric": "save_database (async concurrent, local SSD)",
             "value": round(time.time() - t0, 3), "unit": "s"})
        assert root2 == root, "async tree must be byte-identical"

        from flechasdb_tpu.asyncdb import (
            AsyncLocalFileSystem, load_database as async_load)
        q = x[0]

        async def async_rows():
            fs = AsyncLocalFileSystem(td)
            lats = []
            for _ in range(20):
                t0 = time.time()
                adb = await async_load(fs, f"{root2}.binpb")
                lats.append(time.time() - t0)
            lats.sort()
            log({"metric": "async load_database (root manifest only), p50",
                 "value": round(lats[10] * 1e3, 3), "unit": "ms",
                 "reference_ms": 0.171})
            cold_l, attr_l = [], []
            for _ in range(15):
                ai = await async_load(fs, f"{root2}.binpb")
                t0 = time.time()
                res = await ai.query(q, k=10, nprobe=5)
                cold_l.append(time.time() - t0)
                t0 = time.time()
                got = await asyncio.gather(
                    *(r.get_attribute("tag") for r in res))
                attr_l.append(time.time() - t0)
                assert sum(g is not None for g in got) >= 0
            await adb.query(q, k=10, nprobe=5)     # warm adb's caches
            warm_l = []
            for _ in range(30):
                t0 = time.time()
                res = await adb.query(q, k=10, nprobe=5)
                warm_l.append(time.time() - t0)
            cold_l.sort(), warm_l.sort(), attr_l.sort()
            log({"metric": "async query cold (concurrent lazy loads), p50",
                 "value": round(cold_l[len(cold_l) // 2] * 1e3, 2),
                 "unit": "ms", "reference_ms": 8.04})
            log({"metric": "async query warm, p50",
                 "value": round(warm_l[len(warm_l) // 2] * 1e3, 2),
                 "unit": "ms", "reference_ms": 0.789,
                 "min_ms": round(warm_l[0] * 1e3, 2)})
            log({"metric":
                 "async attribute fetch x10 (cold logs, concurrent), p50",
                 "value": round(attr_l[len(attr_l) // 2] * 1e3, 2),
                 "unit": "ms", "reference_ms": 1.94})

        asyncio.run(async_rows())


if __name__ == "__main__":
    main()
