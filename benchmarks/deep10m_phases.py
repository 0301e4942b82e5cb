"""Per-phase timing of the Deep10M staged build (diagnostic).

`benchmarks/deep10m.py` times the whole `build_staged` call; device work
without an intervening host fence smears into whichever later fetch
fences it, so that number says nothing about WHERE the time goes. This
script drives the same library stages (`ops.kmeans.fit_with_events`,
`parallel.build._sample_residuals` / `_encode_jit`) with a
``block_until_ready`` after each stage, reproducing `build_staged`'s exact
math (same key splits, same caps) while attributing wall time honestly.

Usage: python benchmarks/deep10m_phases.py [--n 10000000] [--rps 8]
Emits one JSON line per phase.
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
    ap.add_argument("--p", type=int, default=4096)
    ap.add_argument("--c", type=int, default=256)
    ap.add_argument("--pq-cap", type=int, default=None,
                    help="PQ training-row cap (default PQ_TRAIN_CAP)")
    ap.add_argument("--fast", action="store_true",
                    help="fast_math numerics (impl='_fast') on both fits")
    ap.add_argument("--rps", type=int, default=8,
                    help="rounds_per_step (build_staged default 8)")
    ap.add_argument("--rps-max", type=int, default=32,
                    help="adaptive per-program round cap (build_staged "
                         "default 32; 0 = fixed rps, the round-3 behavior)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from flechasdb_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from flechasdb_tpu import events as ev
    from flechasdb_tpu.ops import kmeans
    from flechasdb_tpu.parallel import build as pbuild
    from flechasdb_tpu.utils.synth import gmm_pair_device

    n, m, p, d, c = args.n, 96, args.p, 8, args.c
    pq_cap = args.pq_cap or pbuild.PQ_TRAIN_CAP

    def fence(a):
        jax.block_until_ready(a)

    t0 = time.time()
    jax.block_until_ready(jnp.ones((8, 8)) @ jnp.ones((8, 8)))
    log({"phase": "backend warm-up", "s": round(time.time() - t0, 1)})

    t0 = time.time()
    xd, _q = gmm_pair_device(jax.random.key(11), n, 8, m,
                             n_clusters=1024, intrinsic=12)
    fence(xd)
    log({"phase": "prepare (incl. compile on first run)",
         "s": round(time.time() - t0, 1)})

    # ---- build_staged, unrolled with fences (same keys/caps) ----
    def timed_fit(tag, x, k, key, train_cap=None):
        """fit_with_events with a handler that segments wall time into
        seeding / round programs / (unfenced) tail using event arrivals;
        fit_with_events fences each step program via its grads fetch, so
        inter-event walls are real device walls."""
        marks = []

        def handler(e):
            marks.append((time.time(), type(e).__name__,
                          getattr(e, "round", None)))

        t0 = time.time()
        rps_max = args.rps_max if args.rps_max > 0 else None
        res = kmeans.fit_with_events(x, k, key, handler,
                                     rounds_per_step=args.rps,
                                     rounds_per_step_max=rps_max,
                                     impl="_fast" if args.fast else None,
                                     train_cap=train_cap)
        fence(res.indices)      # final assign (train_cap path) fences here
        total = time.time() - t0
        seed = next((t for t, name, _ in marks
                     if name == "FinishedCentroidInitialization"), t0) - t0
        last_ev = marks[-1][0] if marks else t0
        rounds = int(np.max(np.asarray(res.rounds)))
        # Programs dispatched under the doubling schedule (8, 16, 32, ...)
        covered, cur, programs = 0, args.rps, 0
        while covered < rounds:
            covered += cur
            programs += 1
            if rps_max:
                cur = min(cur * 2, rps_max)
        log({"phase": tag, "s": round(total, 2),
             "seed_s": round(seed, 2),
             "rounds_s": round(last_ev - t0 - seed, 2),
             "tail_s": round(t0 + total - last_ev, 2),
             "rounds": rounds,
             "step_programs": programs})
        return res

    # Two identical passes: the first pays the per-fit step-program
    # compiles (the adaptive schedule dispatches ~5 distinct scan
    # lengths per fit, and each compile lands inside the round timers),
    # the second is the device-wall decomposition — the number
    # comparable to deep10m.py's WARM build wall.
    for tag in ("cold", "warm"):
        k_coarse, k_pq, k_sub = jax.random.split(jax.random.key(0), 3)

        coarse = timed_fit(
            f"{tag} coarse fit (cap 2M, K={p}) + full assign",
            xd[None], p, k_coarse, train_cap=pbuild.COARSE_TRAIN_CAP)
        cents, idx = coarse.centroids[0], coarse.indices[0]

        t0 = time.time()
        rows = jax.random.randint(k_sub, (pq_cap,), 0, n)
        sample = pbuild._sample_residuals(xd, cents, idx, rows)
        divided = sample.reshape(pq_cap, d, m // d).transpose(1, 0, 2)
        divided = jax.jit(lambda a: a)(divided)  # materialize the transpose
        fence(divided)
        log({"phase": f"{tag} residual sample + divide ({pq_cap} rows)",
             "s": round(time.time() - t0, 2)})

        pq = timed_fit(f"{tag} pq fit ([{d}, {pq_cap}, {m // d}], C={c})",
                       divided, c, k_pq)

        t0 = time.time()
        codes = pbuild._encode_jit(xd, cents, idx, pq.centroids)
        fence(codes)
        log({"phase": f"{tag} encode 10M codes",
             "s": round(time.time() - t0, 2)})

        t0 = time.time()
        # Fetch what build_staged hands back: narrow dtypes (uint16 pidx,
        # uint8 codes — parallel/build.ShardedBuild), not fit's raw int32.
        pidx = np.asarray(idx.astype(pbuild._pidx_dtype(p)))
        codes_h = np.asarray(codes)
        log({"phase": f"{tag} fetch idx+codes to host",
             "s": round(time.time() - t0, 2),
             "mb": round((pidx.nbytes + codes_h.nbytes) / 1e6, 1)})
        del coarse, cents, idx, sample, divided, pq, codes


if __name__ == "__main__":
    main()
