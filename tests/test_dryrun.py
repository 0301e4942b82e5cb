"""Driver-entry dryrun at awkward device counts.

The driver calls ``dryrun_multichip(8)``; a power-of-two mesh never hits
the row/partition padding seams (``shard_flat`` pad rows, ``fit_sharded``
pad rows, ``shard_buckets`` pad partitions).  n=6 — non-power-of-two and
coprime with the +3 row remainder — exercises every one of them.
Reference scaling design: docs/SCALING.md padding
conventions; reference hot path scaled: kmeans.rs:232-306.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402


@pytest.mark.parametrize("n_devices", [6, 8])
def test_dryrun_multichip(n_devices):
    # conftest forces 8 virtual CPU devices; 6 takes a prefix of them.
    graft.dryrun_multichip(n_devices)


def test_entry_compiles():
    import jax

    fn, args = graft.entry()
    jax.jit(fn).lower(*args).compile()
