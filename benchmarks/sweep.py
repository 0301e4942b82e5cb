"""BASELINE.json benchmark sweep on the accelerator.

Configs (BASELINE.json "configs"):
  * sift: SIFT1M-shaped (1M × 128, P=1024, D=8, C=256) — recall@10 + qps
    over nprobe ∈ {1, 5, 10, 50}
  * gist: GIST1M-shaped (1M × 960, P=1024, D=60, C=256) — high-dim build
    stress (``--scale small`` shrinks N)
  * async: batched queries against a stored DB with attribute fetch
  * mips: the "dot"-metric extension at sift shape — recall@10 vs exact
    max-inner-product ground truth + qps (same build; only scoring changes)

SIFT/GIST are served from disk at the original datasets' homes; this image
has no egress, so the sweep uses clustered GMM synthetic data with
descriptor-like statistics (``flechasdb_tpu.utils.synth`` — mixture of
anisotropic components on a shared low-rank manifold; real descriptor sets
are clustered and far from isotropic, which is exactly what IVF+PQ exploit).
Recall numbers are therefore indicative, not comparable to published SIFT1M
curves; qps and build times are hardware-real. Rerank rows re-score the top
ADC candidates against the raw corpus on device (the standard IVFPQ+refine
serving config).

Usage: python benchmarks/sweep.py [--scale small|full] [--configs sift,gist]
Emits one JSON line per measurement.
"""

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def log(obj):
    print(json.dumps(obj), flush=True)


def synth(rng, n, m, intrinsic, n_clusters=256):
    from flechasdb_tpu.utils.synth import gmm_corpus
    return gmm_corpus(rng, n, m, n_clusters=n_clusters, intrinsic=intrinsic)


def exact_topk_device(x, q, k, metric="l2"):
    """Brute-force ground truth on the device, chunked over the corpus.

    ``metric="dot"`` ranks by the negated inner product (exact MIPS)."""
    import jax
    import jax.numpy as jnp
    from flechasdb_tpu.ops.distance import sqdist

    qd = jnp.asarray(q)
    best_d = jnp.full((len(q), k), jnp.inf)
    best_i = jnp.zeros((len(q), k), jnp.int32)
    step = 1 << 17

    @jax.jit
    def fold(best_d, best_i, chunk, base):
        if metric == "dot":
            d = -jnp.matmul(qd, chunk.T,
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)
        else:
            d = sqdist(qd, chunk)                   # [Q, step]
        idx = (jnp.arange(chunk.shape[0], dtype=jnp.int32) + base)[None, :]
        cat_d = jnp.concatenate([best_d, d], axis=1)
        cat_i = jnp.concatenate([best_i, jnp.broadcast_to(
            idx, d.shape).astype(jnp.int32)], axis=1)
        neg, sel = jax.lax.top_k(-cat_d, k)
        return -neg, jnp.take_along_axis(cat_i, sel, axis=1)

    for i in range(0, len(x), step):
        best_d, best_i = fold(best_d, best_i, jnp.asarray(x[i:i + step]),
                              np.int32(i))
    return np.asarray(best_i)


def run_sift(scale, rng, opq=False):
    import jax
    from flechasdb_tpu.parallel.build import _build_step
    from flechasdb_tpu.ops.bucketed import bucketize, query_bucketed
    import jax.numpy as jnp

    n = 1_000_000 if scale == "full" else 200_000
    m, p, d, c = 128, 1024, 8, 256
    nq, k = 1000, 10
    # On-device generation: the host GMM at 1M x 128 costs minutes of CPU
    # on a small host plus a 512 MB transfer; the device program is ~1 s.
    from flechasdb_tpu.utils.synth import gmm_pair_device
    xd, qdev = gmm_pair_device(jax.random.key(17), n, nq, m,
                               n_clusters=256, intrinsic=12)
    x, q = xd, np.asarray(qdev)
    cfg = "sift-opq" if opq else "sift"
    jax.block_until_ready(xd)        # fence the generation
    t0 = time.time()
    built = _build_step(xd, jax.random.key(0), p=p, d=d, c=c)
    pidx = np.asarray(built.partition_indices)
    compile_and_build = time.time() - t0
    t0 = time.time()
    built = _build_step(xd, jax.random.key(1), p=p, d=d, c=c)
    pidx = np.asarray(built.partition_indices)
    build_s = time.time() - t0
    log({"config": cfg, "metric": f"build {n}x{m} P={p} D={d} C={c}",
         "value": round(build_s, 3), "unit": "s",
         "compile_s": round(compile_and_build - build_s, 1)})

    rotation = None
    codes = built.codes
    if opq:
        from flechasdb_tpu.ops.opq import fit_opq
        resid = xd - jnp.take(built.partition_centroids,
                              built.partition_indices, axis=0)
        t0 = time.time()
        res = fit_opq(resid, d, c, jax.random.key(2), iters=6)
        rotation, codes = res.rotation, res.pq.indices.T
        jax.block_until_ready(codes)
        log({"config": cfg, "metric": "opq training (6 iters)",
             "value": round(time.time() - t0, 2), "unit": "s"})

    gt = exact_topk_device(x, q, k)
    buckets = bucketize(np.asarray(codes), pidx, p)
    qd = jnp.asarray(q)

    for nprobe in (1, 5, 10, 50):
        dists, rows, probed = query_bucketed(
            qd, built.partition_centroids, built.codebooks
            if not opq else res.pq.centroids, buckets, rotation,
            k=k, nprobe=nprobe)
        rows_h = np.asarray(rows)
        recall = np.mean([
            len(set(rows_h[b].tolist()) & set(gt[b].tolist())) / k
            for b in range(nq)])
        # Coarse-only recall: fraction of true neighbors whose PARTITION
        # was probed (truth-in-candidates rate). The end recall@10 can
        # saturate on PQ error (plain PQ sat at 0.589 for nprobe >= 5 on
        # this draw) — this column still moves with
        # the coarse quantizer, so a centroid regression stays visible.
        probed_h = np.asarray(probed)
        coarse = np.mean([np.isin(pidx[gt[b]], probed_h[b]).mean()
                          for b in range(nq)])
        reps = 10
        t0 = time.time()
        for _ in range(reps):
            dists, rows, _ = query_bucketed(
                qd, built.partition_centroids, built.codebooks
                if not opq else res.pq.centroids, buckets, rotation,
                k=k, nprobe=nprobe)
        _ = np.asarray(dists)
        dt = (time.time() - t0) / reps
        log({"config": cfg, "nprobe": nprobe,
             "recall@10": round(float(recall), 4),
             "coarse@10": round(float(coarse), 4),
             "qps": round(nq / dt), "batch_ms": round(dt * 1e3, 2)})

    # IVFPQ + exact refine: re-score the top-100 ADC candidates against the
    # raw corpus on device (the reference keeps residues in memory for the
    # in-memory DB, db/build.rs:156-286; this is its stored-scale analogue).
    import functools as _ft

    @_ft.partial(jax.jit, static_argnames=("k",))
    def refine(qv, rows, xdev, *, k):
        cand = jnp.take(xdev, rows, axis=0)
        ex = jnp.sum((cand - qv[:, None, :]) ** 2, axis=-1)
        neg, sel = jax.lax.top_k(-ex, k)
        return -neg, jnp.take_along_axis(rows, sel, axis=1)

    for nprobe in (5, 10):
        rerank = 100
        dists, rows, _ = query_bucketed(
            qd, built.partition_centroids, built.codebooks
            if not opq else res.pq.centroids, buckets, rotation,
            k=rerank, nprobe=nprobe)
        _, rr = refine(qd, rows, xd, k=k)
        rr_h = np.asarray(rr)
        recall = np.mean([
            len(set(rr_h[b].tolist()) & set(gt[b].tolist())) / k
            for b in range(nq)])
        reps = 10
        t0 = time.time()
        for _ in range(reps):
            dists, rows, _ = query_bucketed(
                qd, built.partition_centroids, built.codebooks
                if not opq else res.pq.centroids, buckets, rotation,
                k=rerank, nprobe=nprobe)
            _, rr = refine(qd, rows, xd, k=k)
        _ = np.asarray(rr)
        dt = (time.time() - t0) / reps
        log({"config": cfg, "nprobe": nprobe, "rerank": rerank,
             "recall@10": round(float(recall), 4),
             "qps": round(nq / dt), "batch_ms": round(dt * 1e3, 2)})


def run_mips(scale, rng):
    """MIPS ("dot" metric) recall + qps at SIFT shape (metrics.py ext).

    Same corpus/build as the sift config (training is L2 for every
    metric); queries rank by negated inner product against exact MIPS
    ground truth. The dot tables are partition-scalar folds — expect qps
    at or above the L2 rows (no per-probe residual einsum).
    """
    import functools as _ft

    import jax
    import jax.numpy as jnp
    from flechasdb_tpu.ops.bucketed import bucketize, query_bucketed
    from flechasdb_tpu.parallel.build import _build_step
    from flechasdb_tpu.utils.synth import gmm_pair_device

    n = 1_000_000 if scale == "full" else 200_000
    m, p, d, c = 128, 1024, 8, 256
    nq, k = 1000, 10
    xd, qdev = gmm_pair_device(jax.random.key(17), n, nq, m,
                               n_clusters=256, intrinsic=12)
    q = np.asarray(qdev)
    jax.block_until_ready(xd)
    t0 = time.time()
    built = _build_step(xd, jax.random.key(0), p=p, d=d, c=c)
    pidx = np.asarray(built.partition_indices)
    cold = time.time() - t0
    t0 = time.time()
    built = _build_step(xd, jax.random.key(1), p=p, d=d, c=c)
    pidx = np.asarray(built.partition_indices)
    build_s = time.time() - t0
    log({"config": "mips", "metric": f"build {n}x{m} P={p} D={d} C={c}",
         "value": round(build_s, 3), "unit": "s",
         "compile_s": round(cold - build_s, 1)})

    gt = exact_topk_device(xd, q, k, metric="dot")
    buckets = bucketize(np.asarray(built.codes), pidx, p)
    qd = jnp.asarray(q)

    @_ft.partial(jax.jit, static_argnames=("k",))
    def refine_ip(qv, rows, xdev, *, k):
        cand = jnp.take(xdev, rows, axis=0)
        ex = -jnp.einsum("bm,brm->br", qv, cand,
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)
        neg, sel = jax.lax.top_k(-ex, k)
        return -neg, jnp.take_along_axis(rows, sel, axis=1)

    for nprobe, rerank in ((1, None), (5, None), (10, None), (50, None),
                           (5, 100), (10, 100)):
        kk = rerank or k
        dists, rows, _ = query_bucketed(
            qd, built.partition_centroids, built.codebooks, buckets,
            k=kk, nprobe=nprobe, metric="dot")
        if rerank:
            _, rows = refine_ip(qd, rows, xd, k=k)
        rows_h = np.asarray(rows)
        recall = np.mean([
            len(set(rows_h[b].tolist()) & set(gt[b].tolist())) / k
            for b in range(nq)])
        reps = 10
        t0 = time.time()
        for _ in range(reps):
            dists, rows, _ = query_bucketed(
                qd, built.partition_centroids, built.codebooks, buckets,
                k=kk, nprobe=nprobe, metric="dot")
            if rerank:
                _, rows = refine_ip(qd, rows, xd, k=k)
        _ = np.asarray(rows)
        dt = (time.time() - t0) / reps
        row = {"config": "mips", "nprobe": nprobe,
               "recall@10": round(float(recall), 4),
               "qps": round(nq / dt), "batch_ms": round(dt * 1e3, 2)}
        if rerank:
            row["rerank"] = rerank
        log(row)


def run_gist(scale, rng, impl=None):
    """``impl`` forwards to the Lloyd-round numerics
    (``ops.kmeans._assign_precision``): ``--impl _fast`` runs the whole build
    with fast_math numerics (``Precision.DEFAULT`` assignment matmuls)."""
    import jax
    import jax.numpy as jnp
    from flechasdb_tpu.parallel.build import build_step_donating

    n = 1_000_000 if scale == "full" else 100_000
    m, p, d, c = 960, 1024, 60, 256
    # On-device generation (host GMM at 1M x 960 is ~15 min of CPU on a
    # 1-vCPU host + a 3.8 GB transfer). Donation invalidates the buffer,
    # so regenerate between the cold and warm builds — same key, ~1 s.
    from flechasdb_tpu.utils.synth import gmm_corpus_device

    def gen():
        xd = gmm_corpus_device(jax.random.key(23), n, m,
                               n_clusters=256, intrinsic=32)
        jax.block_until_ready(xd)    # fence the generation
        return xd

    xd = gen()
    t0 = time.time()
    built = build_step_donating(xd, jax.random.key(0), p=p, d=d, c=c,
                                impl=impl)
    _ = np.asarray(built.partition_indices)
    cold = time.time() - t0
    xd = gen()
    t0 = time.time()
    built = build_step_donating(xd, jax.random.key(1), p=p, d=d, c=c,
                                impl=impl)
    _ = np.asarray(built.partition_indices)
    build_s = time.time() - t0
    log({"config": "gist", "metric": f"build {n}x{m} P={p} D={d} C={c}",
         "value": round(build_s, 3), "unit": "s", "impl": impl,
         "compile_s": round(cold - build_s, 1)})


def run_async(scale, rng):
    import asyncio
    import tempfile

    import flechasdb_tpu as fdb
    from flechasdb_tpu.asyncdb import AsyncLocalFileSystem, load_database

    n, m = 50_000, 128
    from flechasdb_tpu.utils.synth import gmm_pair
    x, q = gmm_pair(rng, n, 1000, m, n_clusters=128, intrinsic=12)
    db = (fdb.DatabaseBuilder(x).with_partitions(64).with_divisions(8)
          .with_clusters(256).with_seed(1).build())
    for i in range(n):
        db.set_attribute_at(i, ("datum_id", i))

    with tempfile.TemporaryDirectory() as td:
        root = fdb.save_database(db, fdb.LocalFileSystem(td))

        async def go():
            adb = await load_database(
                AsyncLocalFileSystem(td), f"{root}.binpb")
            t0 = time.time()
            results = await asyncio.gather(
                *(adb.query(qv, 10, 5) for qv in q[:100]))
            qtime = time.time() - t0
            t0 = time.time()
            await asyncio.gather(*(
                r.get_attribute("datum_id")
                for rs in results for r in rs))
            atime = time.time() - t0
            return qtime, atime

        qtime, atime = asyncio.run(go())
        log({"config": "async", "metric": "100 concurrent cold queries",
             "value": round(qtime * 10, 2), "unit": "ms/query",
             "attr_fetch_1k_ms": round(atime * 1e3, 1)})

        # warm batched device path on the stored DB
        sdb = fdb.load_database(fdb.LocalFileSystem(td), f"{root}.binpb")
        sdb.query_batch(q, 10, 5)  # preload + compile (same shape)
        t0 = time.time()
        sdb.query_batch(q, 10, 5)
        dt = time.time() - t0
        log({"config": "async", "metric": "stored warm batch 1000 queries",
             "value": round(dt * 1e3, 1), "unit": "ms",
             "qps": round(1000 / dt)})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="small", choices=("small", "full"))
    ap.add_argument("--configs", default="sift,gist,async")
    ap.add_argument("--impl", default=None,
                    help="Lloyd kernel/numerics override (e.g. '_fast'); "
                         "gist config only")
    args = ap.parse_args()
    from flechasdb_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    rng = np.random.default_rng(0)
    for cfg in args.configs.split(","):
        if cfg == "sift-opq":
            run_sift(args.scale, rng, opq=True)
        else:
            if cfg == "gist":
                run_gist(args.scale, rng, impl=args.impl)
            else:
                {"sift": run_sift, "async": run_async,
                 "mips": run_mips}[cfg](args.scale, rng)


if __name__ == "__main__":
    main()
