"""Cold-preload benchmark: serial vs concurrent partition loading.

`StoredDatabase.preload` once did P sequential open→inflate→decode
round-trips; it now runs on a thread pool with the
native GIL-released inflate. This measures both at SIFT scale (P=1024).

Usage: python benchmarks/preload_bench.py [--n 200000] [--p 1024]
Emits one JSON line per measurement. Host-side work; device upload is the
same small constant for both.
"""

import argparse
import json
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--p", type=int, default=1024)
    args = ap.parse_args()

    import flechasdb_tpu as fdb
    from flechasdb_tpu.utils.synth import gmm_corpus

    rng = np.random.default_rng(0)
    x = gmm_corpus(rng, args.n, 128, n_clusters=256, intrinsic=12)
    db = (fdb.DatabaseBuilder(x).with_partitions(args.p).with_divisions(8)
          .with_clusters(256).with_seed(0).build())

    with tempfile.TemporaryDirectory() as td:
        root = fdb.save_database(db, fdb.LocalFileSystem(td))

        for workers, label in ((1, "serial"), (None, "concurrent")):
            sdb = fdb.load_database(fdb.LocalFileSystem(td),
                                    f"{root}.binpb")
            t0 = time.time()
            sdb.preload(max_workers=workers)
            dt = time.time() - t0
            print(json.dumps({
                "config": "preload", "mode": label,
                "partitions": args.p, "rows": args.n,
                "value": round(dt, 2), "unit": "s"}), flush=True)


if __name__ == "__main__":
    main()
