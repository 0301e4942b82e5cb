"""Device mesh construction and corpus sharding helpers.

One mesh axis — ``"shard"`` — carries the corpus (vector/code rows). This is
the device equivalent of the reference's per-partition file sharding
(``database.proto:16-39``): independent slices of the corpus live on
independent devices, and only ``k`` candidates per device cross the
interconnect at query time.
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

#: Name of the corpus-sharding mesh axis.
AXIS = "shard"


def corpus_mesh(devices: Sequence[jax.Device] | None = None) -> Mesh:
    """A 1-D mesh over ``devices`` (default: all) with axis :data:`AXIS`."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def put_global(arr, sharding: NamedSharding) -> jax.Array:
    """``device_put`` that also works on MULTI-PROCESS (DCN) meshes.

    On a single-process mesh this is exactly ``jax.device_put``. On a
    ``jax.distributed`` mesh whose devices span several processes,
    ``device_put`` rejects the partly non-addressable sharding; the
    multi-controller contract is instead that every process holds the
    SAME full host value and contributes its addressable shards —
    ``jax.make_array_from_process_local_data`` with global-shaped input.
    (Values numpy cannot hold, e.g. typed PRNG keys, go through a
    replicate-then-reshard jit instead.) Every shard helper in
    :mod:`..parallel` routes through here, which is what lets the same
    build/query programs run unchanged on a multi-host mesh
    (``docs/SCALING.md``; exercised by ``tests/test_multihost.py``).
    """
    if sharding.is_fully_addressable:
        return jax.device_put(arr, sharding)
    try:
        host = np.asarray(arr)
    except Exception:
        return jax.jit(lambda a: a, out_shardings=sharding)(arr)
    return jax.make_array_from_process_local_data(sharding, host,
                                                  host.shape)


def pad_rows(arr: np.ndarray, multiple: int, fill) -> np.ndarray:
    """Pads the leading axis up to a multiple so shards divide evenly."""
    pad = (-arr.shape[0]) % multiple
    if pad == 0:
        return arr
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths, constant_values=fill)


def shard_corpus(mesh: Mesh, codes: np.ndarray, pidx: np.ndarray,
                 ) -> tuple[jax.Array, jax.Array]:
    """Places PQ codes and partition indices across the mesh.

    ``codes: [N, D]`` and ``pidx: [N]`` are padded to a multiple of the mesh
    size (padding rows get ``pidx = -1`` so the masked scan assigns them
    ``+inf`` distance) and sharded row-wise.
    """
    n_dev = mesh.devices.size
    # Builds may hand back narrow (uint8) codes to cheapen the fetch; the
    # serving kernels gather with int32 indices, so widen here.
    codes = pad_rows(np.asarray(codes, np.int32), n_dev, 0)
    pidx = pad_rows(np.asarray(pidx, np.int32), n_dev, -1)
    codes_s = put_global(codes, NamedSharding(mesh, P(AXIS, None)))
    pidx_s = put_global(pidx, NamedSharding(mesh, P(AXIS)))
    return codes_s, pidx_s


def shard_mask(mesh: Mesh, mask: np.ndarray) -> jax.Array:
    """Shards a boolean row mask like :func:`shard_corpus` shards ``pidx``.

    Padding rows get ``False`` (they are already excluded via
    ``pidx == -1``; ``False`` keeps the invariant explicit).
    """
    mask = pad_rows(np.asarray(mask, bool), mesh.devices.size, False)
    return put_global(mask, NamedSharding(mesh, P(AXIS)))


def merge_topk(neg: "jax.Array", rows: "jax.Array", k: int,
               ) -> tuple["jax.Array", "jax.Array"]:
    """k-best merge across the mesh, shared by every sharded query path.

    ``neg [B, k]`` (NEGATED distances, so larger is better) and ``rows
    [B, k]`` are each device's local candidates; ``all_gather`` moves only
    ``k`` rows per device across the interconnect — the device analogue of
    the reference's global ``n_best_by_key`` merge
    (``db/stored.rs:378-387``). Returns ``(sq_distances [B, k],
    rows [B, k] int32)``.
    """
    import jax.numpy as jnp

    b = neg.shape[0]
    negs = jax.lax.all_gather(neg, AXIS)                # [n_dev, B, k]
    rowss = jax.lax.all_gather(rows, AXIS)
    negs = jnp.moveaxis(negs, 0, 1).reshape(b, -1)
    rowss = jnp.moveaxis(rowss, 0, 1).reshape(b, -1)
    mneg, sel = jax.lax.top_k(negs, k)
    mrows = jnp.take_along_axis(rowss, sel, axis=1)
    return -mneg, mrows.astype(jnp.int32)
