"""Smoke run of flechasdb-tpu on one NVIDIA GPU: the main path at real size.

Usage (from the repository root, on a machine with a GPU)::

    python chip_smoke.py [--seed N]      # phases 0-3 on one card
    python chip_smoke.py --four          # phase 0, then the 4-card path only

Phases, each through the entry points a user calls:

0. Device gate: JAX must report a GPU (the script never falls back to the
   CPU); the persistent compile cache is turned on; versions, the card
   and its power limit, and the native IO runtime are printed.
1. Kernel parity at real widths: the ``gpu``-marked tests
   (``tests/test_gpu.py``), run in this process.
2. The reference README's build-random workload (100k × 1536, P=100,
   D=12, C=256, k=10, nprobe=5, a ``datum_id`` on every vector): build,
   save, load sync and async, query five ways, each checked against a
   float64 numpy ADC reference over the STORED index; then the CLI.
3. SIFT1M shape (1M × 128, P=1024, D=8, C=256) generated on the card:
   build, ``query_batch`` at nprobe 1 and 16, ADC parity on 100 queries,
   recall@10 against exact search (itself checked against numpy).
4. ``--four``: the sharded build and queries on 4 cards against their
   single-card forms, and nothing else.

Any failure exits non-zero and prints no result. The last line of stdout
is one JSON object, ``{"ok": true, "device": {"platform", "kind",
"count"}}``; every number before it is labelled with the card's name and
power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Tolerance of every distance comparison with the float64 references:
#: float32 arithmetic, with the order of sums free to differ.
RTOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_label() -> str:
    """``name, power limit`` of the first GPU as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def device_gate(devices) -> None:
    """Fails unless JAX's first device is a GPU."""
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "no device"
        raise SystemExit(f"chip_smoke: JAX found {kind!r}, not a GPU")


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


class _Tally:
    """pytest plugin counting outcomes of the in-process test run."""

    def __init__(self) -> None:
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report) -> None:
        if report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1
        elif report.when == "call":
            self.passed += 1


def phase1_kernels() -> None:
    import pytest

    tally = _Tally()
    rc = pytest.main([os.path.join(ROOT, "tests", "test_gpu.py"), "-m",
                      "gpu", "-q", "-s", "-p", "no:cacheprovider",
                      "--rootdir", ROOT], plugins=[tally])
    if rc != 0 or tally.failed or tally.skipped or not tally.passed:
        raise SystemExit(
            f"phase 1 failed: rc={rc}, passed={tally.passed}, "
            f"failed={tally.failed}, skipped={tally.skipped}")
    log(f"phase 1: {tally.passed} kernel parity tests passed on the card")


# --- float64 references ------------------------------------------------------

def adc_candidates(q, centroids, codebooks, codes, pidx, nprobe):
    """Float64 IVF-PQ reference for one query: rows of the ``nprobe``
    nearest partitions and their ADC squared distances."""
    cents = np.asarray(centroids, np.float64)
    cbs = np.asarray(codebooks, np.float64)
    q = np.asarray(q, np.float64)
    d = cbs.shape[0]
    probed = np.argsort(((cents - q) ** 2).sum(1), kind="stable")[:nprobe]
    rows = np.flatnonzero(np.isin(pidx, probed))
    recon = cbs[np.arange(d)[None, :], codes[rows]].reshape(len(rows), -1)
    resid = q - cents[pidx[rows]]
    keys = ((resid - recon) ** 2).sum(1)
    scale = float((resid ** 2).sum(1).max()) if len(rows) else 0.0
    return rows, keys, scale


def check_topk(what, got_ids, got_d, cand_ids, cand_keys, k, atol):
    """``got`` (ids, distances ascending) must be the reference's top-k:
    the same distances within RTOL, and the same ids except where the
    k-th place ties within that tolerance."""
    order = np.argsort(cand_keys, kind="stable")[:k]
    want_d = cand_keys[order]
    want_ids = {cand_ids[i] for i in order}
    if len(got_ids) != len(order):
        raise AssertionError(f"{what}: {len(got_ids)} results, want "
                             f"{len(order)}")
    np.testing.assert_allclose(np.asarray(got_d, np.float64), want_d,
                               rtol=RTOL, atol=atol, err_msg=what)
    key_of = dict(zip(cand_ids, cand_keys))
    kth = want_d[-1]
    for gid, gd in zip(got_ids, got_d):
        if gid not in key_of:
            raise AssertionError(f"{what}: {gid} is not in a probed "
                                 "partition")
        if abs(key_of[gid] - gd) > RTOL * abs(key_of[gid]) + atol:
            raise AssertionError(f"{what}: distance of {gid} is {gd}, "
                                 f"reference {key_of[gid]}")
        if gid not in want_ids and key_of[gid] > kth * (1 + RTOL) + atol:
            raise AssertionError(f"{what}: {gid} is not a top-{k} tie")


# --- phase 2: the reference README's workload ---------------------------------

def phase2_reference(card: str, seed: int) -> None:
    import jax

    import flechasdb_tpu as fdb
    from flechasdb_tpu.__main__ import main as cli
    from flechasdb_tpu.asyncdb import AsyncLocalFileSystem
    from flechasdb_tpu.asyncdb import load_database as load_async

    n, m, p, d, c, k, nprobe = 100_000, 1536, 100, 12, 256, 10, 5
    x = jax.random.uniform(jax.random.key(seed), (n, m))   # np.random.rand
    q = np.asarray(x[:64])
    t0 = time.perf_counter()
    db = (fdb.DatabaseBuilder(x).with_partitions(p).with_divisions(d)
          .with_clusters(c).with_seed(seed).build())
    build_s = time.perf_counter() - t0
    for i in range(n):
        db.set_attribute_at(i, ("datum_id", i))
    row_of = {vid: i for i, vid in enumerate(db.vector_ids)}
    log(f"[{card}] phase 2: build {n}x{m} (P={p}, D={d}, C={c}) "
        f"{build_s:.3f} s, first build in this process (includes "
        f"compilation); serving layout {db._device_state().layout}")

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        store = os.path.join(tmp, "db")
        root = fdb.save_database(db, fdb.LocalFileSystem(store))
        sdb = fdb.load_database(fdb.LocalFileSystem(store), f"{root}.binpb")
        ref = sdb.to_database()          # the stored index, materialized
        ref_ids = ref.vector_ids

        def check(what, results, qv):
            rows, keys, scale = adc_candidates(
                qv, ref.partition_centroids, ref.codebooks, ref.codes,
                ref.partition_indices, nprobe)
            check_topk(what, [r.vector_id for r in results],
                       [r.squared_distance for r in results],
                       [ref_ids[r] for r in rows], keys, k,
                       atol=RTOL * scale)

        def check_attrs(what, results, attrs):
            want = [row_of[r.vector_id] for r in results]
            if list(attrs) != want:
                raise AssertionError(f"{what}: datum_id {attrs} != {want}")

        sdb_cold = fdb.load_database(fdb.LocalFileSystem(store),
                                     f"{root}.binpb")
        for i in range(8):                   # host ADC path (not preloaded)
            res = sdb_cold.query(q[i], k=k, nprobe=nprobe)
            check(f"cold query {i}", res, q[i])
            check_attrs(f"cold query {i}", res,
                        [r.get_attribute("datum_id") for r in res])

        sdb.preload()                        # device path from here on
        res = sdb.query(q[0], k=k, nprobe=nprobe)
        check("warm query", res, q[0])
        lat = []
        for i in range(32):
            t0 = time.perf_counter()
            sdb.query(q[i % 64], k=k, nprobe=nprobe)
            lat.append(time.perf_counter() - t0)
        log(f"[{card}] phase 2: warm single query (device path) p50 "
            f"{np.median(lat[2:]) * 1e3:.3f} ms over 30 queries")

        batch = sdb.query_batch(q, k=k, nprobe=nprobe)
        for i, res in enumerate(batch):
            check(f"query_batch row {i}", res, q[i])
            check_attrs(f"query_batch row {i}", res,
                        [r.get_attribute("datum_id") for r in res])

        async def async_path():
            adb = await load_async(AsyncLocalFileSystem(store),
                                   f"{root}.binpb")
            res = await adb.query(q[0], k=k, nprobe=nprobe)
            attrs = await asyncio.gather(
                *(r.get_attribute("datum_id") for r in res))
            return res, attrs

        res, attrs = asyncio.run(async_path())
        check("async query", res, q[0])
        check_attrs("async query", res, attrs)
        vid = db.vector_ids[12345]
        if sdb.get_attribute(vid, "datum_id") != 12345:
            raise AssertionError("get_attribute did not round-trip")
        log("phase 2: cold host, warm device, batched and async queries "
            "match the float64 ADC reference over the stored index; "
            "attributes round-trip")

        out = io.StringIO()
        cli_dir = os.path.join(tmp, "cli")
        with contextlib.redirect_stdout(out):
            rcs = (cli(["generate", cli_dir]), cli(["load", cli_dir]))
        if any(rc not in (0, None) for rc in rcs):
            raise SystemExit(f"CLI failed: {rcs}\n{out.getvalue()}")
        log(f"phase 2: CLI generate + load ran ({len(out.getvalue())} "
            "bytes of output)")


# --- phase 3: SIFT1M shape ---------------------------------------------------

def _exact_reference(q, x, k):
    """Float64 exact k-NN over host rows, chunked: ``(rows, dists)``."""
    best_d = np.full((len(q), k), np.inf)
    best_r = np.zeros((len(q), k), np.int64)
    q64 = q.astype(np.float64)
    for s in range(0, len(x), 1 << 18):
        xc = x[s:s + (1 << 18)].astype(np.float64)
        dist = ((q64 ** 2).sum(1)[:, None] + (xc ** 2).sum(1)[None]
                - 2.0 * q64 @ xc.T)
        cat_d = np.concatenate([best_d, dist], 1)
        cat_r = np.concatenate(
            [best_r, np.broadcast_to(np.arange(s, s + len(xc)), dist.shape)],
            1)
        sel = np.argpartition(cat_d, k - 1, axis=1)[:, :k]
        best_d = np.take_along_axis(cat_d, sel, 1)
        best_r = np.take_along_axis(cat_r, sel, 1)
    order = np.argsort(best_d, 1)
    return (np.take_along_axis(best_r, order, 1),
            np.take_along_axis(best_d, order, 1))


def phase3_sift(card: str, seed: int) -> None:
    import jax

    import flechasdb_tpu as fdb
    from flechasdb_tpu.ops.exact import exact_topk
    from flechasdb_tpu.utils.synth import gmm_pair_device

    n, nq, m, p, d, c, k = 1_000_000, 1000, 128, 1024, 8, 256, 10
    t0 = time.perf_counter()
    xd, qd = jax.block_until_ready(gmm_pair_device(
        jax.random.key(seed + 1), n, nq, m, n_clusters=1024))
    log(f"[{card}] phase 3: generated {n}x{m} + {nq} queries on the card "
        f"in {time.perf_counter() - t0:.3f} s")
    q = np.asarray(qd)

    def build():
        t0 = time.perf_counter()
        db = (fdb.DatabaseBuilder(xd).with_partitions(p).with_divisions(d)
              .with_clusters(c).with_seed(seed).build())
        return db, time.perf_counter() - t0

    db, first_s = build()
    db, warm_s = build()
    log(f"[{card}] phase 3: build {n}x{m} (P={p}, D={d}, C={c}) "
        f"{warm_s:.3f} s warm; first build {first_s:.3f} s, so compiling "
        f"took about {first_s - warm_s:.3f} s; serving layout "
        f"{db._device_state().layout}")

    t0 = time.perf_counter()
    ex_d, ex_r = jax.block_until_ready(exact_topk(qd, xd, k=k))
    exact_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex_d, ex_r = jax.block_until_ready(exact_topk(qd, xd, k=k))
    log(f"[{card}] phase 3: exact top-{k} of {nq} queries on the card "
        f"{time.perf_counter() - t0:.3f} s warm (first {exact_first:.3f} s)")
    ex_d, ex_r = np.asarray(ex_d), np.asarray(ex_r)
    x_host = np.asarray(xd)
    ref_r, ref_d = _exact_reference(q[:100], x_host, k)
    xnorm = np.linalg.norm(x_host, axis=1).max()
    for i in range(100):
        cand = np.union1d(ref_r[i], ex_r[i])
        check_topk(f"exact query {i}", ex_r[i].tolist(), ex_d[i],
                   cand.tolist(), _sqdist64(q[i], x_host, cand), k,
                   atol=RTOL * np.linalg.norm(q[i]) * xnorm)

    row_of = {vid: i for i, vid in enumerate(db.vector_ids)}
    for nprobe in (1, 16):
        t0 = time.perf_counter()
        res = db.query_batch(q, k=k, nprobe=nprobe)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = db.query_batch(q, k=k, nprobe=nprobe)
        warm = time.perf_counter() - t0
        got = [[row_of[r.vector_id] for r in rs] for rs in res]
        recall = np.mean([len(set(g) & set(e)) / k
                          for g, e in zip(got, ex_r.tolist())])
        for i in range(100):
            rows, keys, scale = adc_candidates(
                q[i], db.partition_centroids, db.codebooks, db.codes,
                db.partition_indices, nprobe)
            check_topk(f"query_batch nprobe={nprobe} row {i}", got[i],
                       [r.squared_distance for r in res[i]], rows.tolist(),
                       keys, k, atol=RTOL * scale)
        log(f"[{card}] phase 3: query_batch {nq} queries nprobe={nprobe}: "
            f"{warm * 1e3:.3f} ms warm (first {first * 1e3:.3f} ms), "
            f"recall@{k} {recall:.4f} against exact search")

    # The skewed partitions of this corpus make the serving tier pick the
    # masked layout; the bucketed layout (the bucket scan) is checked
    # here on the same index.
    from flechasdb_tpu.serving import DeviceIndex
    idx = DeviceIndex(db.partition_centroids, db.codebooks, db.codes,
                      db.partition_indices, layout="bucketed")
    bd, br, _ = idx.query(q[:100], k, 16)
    for i in range(100):
        rows, keys, scale = adc_candidates(
            q[i], db.partition_centroids, db.codebooks, db.codes,
            db.partition_indices, 16)
        check_topk(f"bucketed layout row {i}", br[i].tolist(), bd[i],
                   rows.tolist(), keys, k, atol=RTOL * scale)
    log(f"phase 3: bucketed layout (L={idx.buckets.codes.shape[2]}) "
        "matches the float64 ADC reference on 100 queries at nprobe 16")
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    log(f"[{card}] phase 3: peak device memory {peak / 2**30:.3f} GiB; "
        "ADC parity on 100 queries at nprobe 1 and 16 and exact search "
        "parity on 100 queries hold")


def _sqdist64(q, x, rows):
    diff = x[rows].astype(np.float64) - q.astype(np.float64)
    return (diff ** 2).sum(1)


# --- phase 4: four cards -----------------------------------------------------

def _spans(a, n_dev: int, what: str) -> None:
    devs = {s.device for s in a.addressable_shards}
    if len(devs) != n_dev:
        raise AssertionError(f"{what} spans {len(devs)} devices, not "
                             f"{n_dev}")


def phase4_four(card: str, seed: int) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from flechasdb_tpu.ops.adc import query_masked_scan
    from flechasdb_tpu.ops.bucketed import bucketize, query_bucketed
    from flechasdb_tpu.ops.exact import exact_topk
    from flechasdb_tpu.parallel import (build_sharded, corpus_mesh,
                                        exact_sharded, query_sharded,
                                        shard_corpus, shard_flat)
    from flechasdb_tpu.parallel.bucketed import (query_bucketed_sharded,
                                                 shard_buckets)
    from flechasdb_tpu.parallel.mesh import AXIS
    from flechasdb_tpu.utils.synth import gmm_pair_device

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"--four needs 4 GPUs, JAX found {len(devices)}")
    n_dev, n, nq, m, p, d, c, k, nprobe = 4, 4_000_000, 1000, 128, 1024, \
        8, 256, 10, 16
    mesh = corpus_mesh(devices[:n_dev])
    rep = NamedSharding(mesh, P())
    xd, qd = gmm_pair_device(jax.random.key(seed + 1), n, nq, m,
                             n_clusters=1024)
    xs = jax.device_put(xd, NamedSharding(mesh, P(AXIS, None)))
    _spans(xs, n_dev, "corpus")
    t0 = time.perf_counter()
    built = jax.block_until_ready(build_sharded(
        xs, p, d, c, jax.device_put(jax.random.key(seed), rep), mesh=mesh))
    log(f"[{card}] four cards: sharded build {n}x{m} (P={p}, D={d}, "
        f"C={c}) {time.perf_counter() - t0:.3f} s including compilation")
    _spans(built.codes, n_dev, "codes")
    codes = np.asarray(built.codes)
    pidx = np.asarray(built.partition_indices)
    cents = np.asarray(built.partition_centroids)
    cbs = np.asarray(built.codebooks)

    def single(a):
        return jax.device_put(a, devices[0])

    q1 = single(qd)
    buckets = bucketize(codes, pidx, p, pack="auto")
    sb = shard_buckets(mesh, buckets)
    for name in ("codes", "rows", "lengths"):
        _spans(getattr(sb, name), n_dev, f"buckets.{name}")
    qr = jax.device_put(qd, rep)
    sd, sr, sp = query_bucketed_sharded(
        qr, jax.device_put(cents, rep), jax.device_put(cbs, rep), sb,
        mesh=mesh, k=k, nprobe=nprobe)
    b1 = type(buckets)(*(single(a) for a in buckets))
    rd, rr, rp = query_bucketed(q1, single(cents), single(cbs), b1, k=k,
                                nprobe=nprobe)
    np.testing.assert_array_equal(np.asarray(sp), np.asarray(rp))
    np.testing.assert_allclose(np.asarray(sd), np.asarray(rd), rtol=RTOL,
                               atol=RTOL * float(np.abs(rd).max()))
    log("four cards: query_bucketed_sharded matches query_bucketed "
        f"({nq} queries, nprobe={nprobe})")

    b = 64                                  # the masked scan is O(B·N)
    codes_s, pidx_s = shard_corpus(mesh, codes, pidx)
    _spans(codes_s, n_dev, "masked codes")
    md, mr, mp = query_sharded(
        jax.device_put(qd[:b], rep), jax.device_put(cents, rep),
        jax.device_put(cbs, rep), codes_s, pidx_s, mesh=mesh, k=k,
        nprobe=nprobe)
    od, orr, op = query_masked_scan(
        q1[:b], single(cents), single(cbs),
        single(jnp.asarray(codes.astype(np.int32))),
        single(jnp.asarray(pidx.astype(np.int32))), k=k, nprobe=nprobe)
    np.testing.assert_array_equal(np.asarray(mp), np.asarray(op))
    np.testing.assert_allclose(np.asarray(md), np.asarray(od), rtol=RTOL,
                               atol=RTOL * float(np.abs(od).max()))
    log(f"four cards: query_sharded matches query_masked_scan ({b} "
        "queries)")

    x_host = np.asarray(xd)
    xf, true_n = shard_flat(mesh, x_host)
    _spans(xf, n_dev, "flat corpus")
    ed, er = exact_sharded(jax.device_put(qd, rep), xf, mesh=mesh, k=k,
                           n=true_n)
    fd, fr = exact_topk(q1, single(xd), k=k)
    scale = float(np.linalg.norm(np.asarray(qd), axis=1).max()
                  * np.linalg.norm(x_host, axis=1).max())
    np.testing.assert_allclose(np.asarray(ed), np.asarray(fd), rtol=RTOL,
                               atol=RTOL * scale)
    same = (np.sort(np.asarray(er), 1) == np.sort(np.asarray(fr), 1)).mean()
    log(f"four cards: exact_sharded matches exact_topk (row agreement "
        f"{same:.5f}, distances within rtol {RTOL})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on 4 cards")
    args = ap.parse_args(argv)

    import jax

    if not args.four:                       # one process, one card
        jax.config.update("jax_cuda_visible_devices", "0")
    devices = jax.devices()
    device_gate(devices)
    from flechasdb_tpu import _native
    from flechasdb_tpu.utils.cache import enable_compilation_cache

    cache_dir = enable_compilation_cache()
    card = card_label()
    log(f"jax {jax.__version__}; device {devices[0].device_kind} "
        f"x{len(devices)}; card {card}; native IO runtime "
        f"{'loaded' if _native._load() is not None else 'NOT loaded'}; "
        f"compile cache {cache_dir}")
    if args.four:
        phase4_four(card, args.seed)
    else:
        phase1_kernels()
        phase2_reference(card, args.seed)
        phase3_sift(card, args.seed)
    log(f"card: {card}")
    print(result_line(devices), flush=True)


if __name__ == "__main__":
    main()
