"""Build a database from 100k random 1536-d vectors and save it.

Python rendition of the reference walkthrough (``examples/build-random``,
100k×1536, P=100, D=12, C=256): the build that takes ~906 s on an M1 Pro CPU
(the reference README's number) runs on the accelerator JAX finds.

Usage: python examples/build_random.py [testdb]
"""

import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from flechasdb_tpu import DatabaseBuilder, LocalFileSystem, save_database

M, N, D, P, C = 100_000, 1536, 12, 100, 256


def main(path: str = "testdb") -> None:
    t = time.time()
    rng = np.random.default_rng()
    data = rng.random((M, N), dtype=np.float32)
    print(f"prepared data in {time.time() - t:.3f} s")

    t = time.time()
    db = (DatabaseBuilder(data)
          .with_partitions(P)
          .with_divisions(D)
          .with_clusters(C)
          .build())
    print(f"built database in {time.time() - t:.3f} s")

    for i in range(M):
        db.set_attribute_at(i, ("datum_id", i))

    t = time.time()
    save_database(db, LocalFileSystem(path))
    print(f"serialized database in {time.time() - t:.3f} s")


if __name__ == "__main__":
    main(*sys.argv[1:2])
