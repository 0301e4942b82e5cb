"""Deep10M-scale single-chip benchmark (BASELINE.json "Deep10M scale-up").

10M × 96 f32 (3.84 GB) fits one card's device memory, so the scale-up
config's build/query numbers are measurable on one device; the 8-device
CPU-mesh run (`benchmarks/deep_sharded.py`) remains the
sharding-correctness cross-check at reduced N.

Memory plan for the build: the corpus is the dominant tenant, so the input
buffer is DONATED to the build program (residuals alias it,
`parallel/build.py:60-66`) and re-uploaded afterwards for ground truth /
rerank. Query ground truth streams through `ops/exact.exact_topk` chunks.

Usage: python benchmarks/deep10m.py [--n 10000000] [--nq 200]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--nq", type=int, default=200)
    ap.add_argument("--fast", action="store_true",
                    help="fast_math build (impl='_fast' on both fits); the"
                         " recall rows then show the quality cost")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from flechasdb_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from flechasdb_tpu import events as ev
    from flechasdb_tpu.ops.bucketed import bucketize, query_bucketed
    from flechasdb_tpu.ops.exact import exact_topk
    from flechasdb_tpu.parallel.build import build_staged
    from flechasdb_tpu.utils.synth import gmm_pair_device

    n, m, p, d, c = args.n, 96, 4096, 8, 256
    nq, k = args.nq, 10

    # Burn backend start-up on a tiny op so phase timers measure workload.
    t0 = time.time()
    jax.block_until_ready(jnp.ones((8, 8)) @ jnp.ones((8, 8)))
    log({"config": "deep10m", "metric": "backend warm-up (tiny op)",
         "value": round(time.time() - t0, 1), "unit": "s"})
    # Generate ON DEVICE: the chunked device program fills device memory
    # directly, with no host generator or transfer. The first pass pays
    # trace+compile and is freed before the timed pass at the same shape.
    t0 = time.time()
    xd, qd0 = jax.block_until_ready(gmm_pair_device(
        jax.random.key(11), n, nq, m, n_clusters=1024, intrinsic=12))
    log({"config": "deep10m", "metric": f"prepare {n}x{m} incl. compile",
         "value": round(time.time() - t0, 1), "unit": "s"})
    xd.delete(), qd0.delete()
    t0 = time.time()
    xd, qd0 = gmm_pair_device(jax.random.key(11), n, nq, m,
                              n_clusters=1024, intrinsic=12)
    jax.block_until_ready((xd, qd0))
    log({"config": "deep10m", "metric": f"prepare {n}x{m} (on device, warm)",
         "value": round(time.time() - t0, 1), "unit": "s"})

    # ---- build (staged: per-round device programs with progress) ----
    def progress(e):
        if isinstance(e, ev.FinishedCentroidUpdate) and e.round % 20 == 0:
            print(f"  round {e.round}", file=sys.stderr, flush=True)

    impl = "_fast" if args.fast else None
    t0 = time.time()
    built = build_staged(xd, p, d, c, jax.random.key(0), progress, impl=impl)
    pidx = np.asarray(built.partition_indices)
    cold = time.time() - t0
    t0 = time.time()
    built = build_staged(xd, p, d, c, jax.random.key(1), impl=impl)
    pidx = np.asarray(built.partition_indices)
    build_s = time.time() - t0
    pops = np.unique(pidx).size
    cfgname = "deep10m-fast" if args.fast else "deep10m"
    log({"config": cfgname, "metric": f"build {n}x{m} P={p} D={d} C={c}",
         "value": round(build_s, 2), "unit": "s",
         "compile_s": round(cold - build_s, 1),
         "partitions_populated": int(pops)})

    # ---- ground truth (exact scan on device, chunked) ----
    qd = qd0
    t0 = time.time()
    gt_d, gt_rows = exact_topk(qd, xd, k=k)
    gt = np.asarray(gt_rows)
    log({"config": cfgname, "metric": f"exact scan {nq} queries",
         "value": round(time.time() - t0, 2), "unit": "s",
         "qps": round(nq / (time.time() - t0))})

    # ---- IVF-PQ serving sweep ----
    codes = np.asarray(built.codes)
    counts = np.bincount(pidx, minlength=p)
    buckets = bucketize(codes, pidx, p, pack="auto")
    l_pad = int(buckets.codes.shape[2])
    words = int(buckets.codes.shape[1])
    log({"config": cfgname, "metric": "bucket stats",
         "avg_len": round(float(counts.mean()), 1),
         "max_len": int(counts.max()), "l_pad": l_pad,
         "packed_words": words,
         "padded_gb": round(p * l_pad * (words + 1) * 4 / 1e9, 2)})

    # The bucket gather materializes [B, nprobe, D, L]; chunk the query
    # batch so that transient stays under ~1.5 GB (serving.py applies the
    # same discipline for the masked layout).
    def chunk_for(nprobe):
        per_q = nprobe * l_pad * (d + 2) * 4
        return max(1, min(nq, int(1.5e9 / per_q)))

    def run_batched(qdev, kk, nprobe):
        cb = chunk_for(nprobe)
        outs = []
        for i in range(0, len(qdev), cb):
            qc = qdev[i:i + cb]
            if len(qc) < cb:                      # static shape: pad + slice
                qc = jnp.pad(qc, ((0, cb - len(qc)), (0, 0)))
            outs.append(query_bucketed(
                qc, built.partition_centroids, built.codebooks, buckets,
                k=kk, nprobe=nprobe))
        dists = np.concatenate([np.asarray(o[0]) for o in outs])[:len(qdev)]
        rows = np.concatenate([np.asarray(o[1]) for o in outs])[:len(qdev)]
        return dists, rows

    for nprobe in (8, 32, 128):
        _, rows_h = run_batched(qd, k, nprobe)
        recall = np.mean([
            len(set(rows_h[b].tolist()) & set(gt[b].tolist())) / k
            for b in range(nq)])
        reps = 5
        t0 = time.time()
        for _ in range(reps):
            _, rows_h = run_batched(qd, k, nprobe)
        dt = (time.time() - t0) / reps
        log({"config": cfgname, "nprobe": nprobe,
             "recall@10": round(float(recall), 4),
             "qps": round(nq / dt), "batch_ms": round(dt * 1e3, 2),
             "query_chunk": chunk_for(nprobe)})

    # ---- rerank row: top-100 ADC candidates re-scored exactly ----
    import functools

    @functools.partial(jax.jit, static_argnames=("k",))
    def refine(qv, rows, xdev, *, k):
        cand = jnp.take(xdev, rows, axis=0)
        ex = jnp.sum((cand - qv[:, None, :]) ** 2, axis=-1)
        neg, sel = jax.lax.top_k(-ex, k)
        return -neg, jnp.take_along_axis(rows, sel, axis=1)

    nprobe, rerank = 32, 100
    from flechasdb_tpu.serving import _query_rerank_fused

    def run_rerank():
        # The production fused path (serving.query_rerank): ADC query +
        # exact re-score + final top-k in ONE program per chunk.
        cb = chunk_for(nprobe)
        outs = []
        for i in range(0, len(qd), cb):
            qc = qd[i:i + cb]
            if len(qc) < cb:
                qc = jnp.pad(qc, ((0, cb - len(qc)), (0, 0)))
            _, rr = _query_rerank_fused(
                qc, built.partition_centroids, built.codebooks, buckets,
                None, None, xd, k=k, nprobe=nprobe, rerank=rerank,
                metric="l2")
            outs.append(np.asarray(rr))
        return np.concatenate(outs)[:len(qd)]

    rr_h = run_rerank()
    recall = np.mean([
        len(set(rr_h[b].tolist()) & set(gt[b].tolist())) / k
        for b in range(nq)])
    reps = 5
    t0 = time.time()
    for _ in range(reps):
        rr_h = run_rerank()
    dt = (time.time() - t0) / reps
    log({"config": cfgname, "nprobe": nprobe, "rerank": rerank,
         "recall@10": round(float(recall), 4),
         "qps": round(nq / dt), "batch_ms": round(dt * 1e3, 2)})


if __name__ == "__main__":
    main()
