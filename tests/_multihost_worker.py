"""Worker body for the two-process DCN-boundary dryrun.

Run as ``python _multihost_worker.py <process_id> <coordinator_port>``.
Each of the two processes exposes 4 virtual CPU devices; together they
form an 8-device mesh whose axis crosses a ``jax.distributed`` process
boundary — the same seam a multi-HOST mesh crosses over the network. The
checks are the core of ``__graft_entry__._dryrun_checks`` (build +
sharded queries + parity against the single-program path), adapted only
in how results are fetched: every asserted value is replicated (post
``all_gather`` / ``psum``), so each process reads its local copy.

docs/SCALING.md claims the mesh programs scale to a multi-host mesh
unchanged; this worker is what backs that claim with an executed
program (single-process virtual meshes cannot: GSPMD only inserts
cross-process collectives when processes really disagree on
addressability).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4").strip()

import numpy as np  # noqa: E402


def main() -> None:
    pid = int(sys.argv[1])
    port = sys.argv[2]

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2, jax.process_count()
    assert jax.local_device_count() == 4
    assert jax.device_count() == 8

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from flechasdb_tpu.parallel import (
        build_sharded, corpus_mesh, exact_sharded, query_sharded,
        rerank_sharded, shard_corpus, shard_flat)
    from flechasdb_tpu.parallel.mesh import put_global
    from flechasdb_tpu.parallel.bucketed import (query_bucketed_sharded,
                                                 shard_buckets)
    from flechasdb_tpu.ops.bucketed import bucketize, query_bucketed

    mesh = corpus_mesh(jax.devices())
    replicated = NamedSharding(mesh, P())

    # Identical host data on both processes (same seed) — the global
    # device_put contract.
    rng = np.random.default_rng(0)
    n, m, p, d, c = 64 * 8 + 3, 32, 4, 4, 8
    x = rng.standard_normal((n, m)).astype(np.float32)

    key = put_global(jax.random.key(0), replicated)
    built = build_sharded(x, p, d, c, key, mesh=mesh)
    jax.block_until_ready(built.partition_centroids)
    assert built.partition_centroids.shape == (p, m)
    assert built.codes.shape == (n, d)

    # Replicated outputs are locally addressable on every process.
    codes_h = np.asarray(built.codes)
    pidx_h = np.asarray(built.partition_indices)

    codes_s, pidx_s = shard_corpus(mesh, codes_h, pidx_h)
    q = put_global(
        np.asarray(rng.standard_normal((4, m)), np.float32), replicated)
    dists, rows, probed = query_sharded(
        q, built.partition_centroids, built.codebooks,
        codes_s, pidx_s, mesh=mesh, k=5, nprobe=2)
    jax.block_until_ready(dists)
    assert dists.shape == (4, 5) and rows.shape == (4, 5)
    assert bool(jnp.all(jnp.isfinite(dists)))

    xs, true_n = shard_flat(mesh, x)
    ed, er = exact_sharded(q, xs, mesh=mesh, k=3, n=true_n)
    jax.block_until_ready(ed)
    assert ed.shape == (4, 3) and bool(jnp.all(er < true_n))

    # Sharded bucketed query vs the single-program reference, computed
    # on replicated inputs in THIS process.
    buckets = bucketize(codes_h, pidx_h, p, pack="auto")
    sb = shard_buckets(mesh, buckets)
    bd, br, bp = query_bucketed_sharded(
        q, built.partition_centroids, built.codebooks, sb,
        mesh=mesh, k=5, nprobe=2)
    jax.block_until_ready(bd)
    rd, rr, rp = query_bucketed(
        np.asarray(q), np.asarray(built.partition_centroids),
        np.asarray(built.codebooks), buckets, k=5, nprobe=2)
    np.testing.assert_allclose(np.asarray(bd), np.asarray(rd),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(bp), np.asarray(rp))

    # Sharded exact rerank across the process boundary.
    vd, vr = rerank_sharded(q, br, jnp.isfinite(bd), xs, mesh=mesh, k=3)
    jax.block_until_ready(vd)
    assert vd.shape == (4, 3) and bool(jnp.all(jnp.isfinite(vd)))

    print(f"MULTIHOST_OK pid={pid}", flush=True)


if __name__ == "__main__":
    main()
