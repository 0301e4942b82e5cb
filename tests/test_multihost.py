"""Two-process DCN-boundary dryrun.

``docs/SCALING.md`` states the mesh programs scale to a multi-host mesh
unchanged. A single-process virtual mesh cannot actually test that:
only when devices belong to DIFFERENT processes does GSPMD emit real
cross-process collectives and does every host-side seam (device_put of
host arrays onto a partly non-addressable sharding, fetching replicated
results) cross the boundary a multi-host mesh crosses over the network.

This test spawns two ``jax.distributed`` CPU processes (4 virtual
devices each → one 8-device mesh) running
``tests/_multihost_worker.py``: sharded build, sharded/bucketed/exact
queries, rerank, and parity against the single-program path. The
driver-facing ``__graft_entry__.dryrun_multichip`` is unchanged (still
single-process, per the driver contract).
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dcn_mesh():
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # Each process gets its own device count via the worker; scrub any
    # ambient 8-device flag so the per-process count is 4.
    env["XLA_FLAGS"] = ""
    repo = str(HERE.parent)
    parts = [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p and p != repo]
    env["PYTHONPATH"] = os.pathsep.join(parts)

    procs = [
        subprocess.Popen(
            [sys.executable, str(HERE / "_multihost_worker.py"),
             str(pid), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in (0, 1)
    ]
    deadline = time.time() + 600
    outs = [None, None]
    try:
        for i, pr in enumerate(procs):
            left = max(5.0, deadline - time.time())
            outs[i], _ = pr.communicate(timeout=left)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    for i, pr in enumerate(procs):
        assert pr.returncode == 0, (
            f"worker {i} rc={pr.returncode}:\n{outs[i]}")
        assert f"MULTIHOST_OK pid={i}" in outs[i], outs[i]
