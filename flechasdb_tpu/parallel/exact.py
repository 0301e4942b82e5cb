"""SPMD sharded exact (flat) k-NN.

Same shape as :mod:`.query`: the raw corpus rows shard over the ``"shard"``
axis, each device runs the chunked exact scan (:mod:`..ops.exact`) on its
local rows, and only ``k`` candidates per device cross the mesh in the
``all_gather`` merge.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.exact import exact_topk
from .mesh import AXIS, merge_topk, pad_rows, put_global


def shard_flat(mesh: Mesh, x: np.ndarray) -> tuple[jax.Array, int]:
    """Row-shards the corpus; returns ``(sharded [N_pad, M], true_n)``."""
    n = len(x)
    xp = pad_rows(np.asarray(x, np.float32), mesh.devices.size, 0.0)
    xs = put_global(xp, NamedSharding(mesh, P(AXIS, None)))
    return xs, n


def _local(q, x, row_mask=None, *, k, kk, n, metric):
    nloc = x.shape[0]
    base = jax.lax.axis_index(AXIS) * nloc
    # Select kk = min(k + n_pad, nloc) candidates so that even if every pad
    # row (zero vector, global id >= n) wins a slot, k true neighbours still
    # survive the mask below — pad rows must never displace real rows.
    d, rows = exact_topk(q, x, row_mask, k=kk, metric=metric)
    rows = rows + base
    d = jnp.where(rows < n, d, jnp.inf)                 # mask pad rows
    if d.shape[1] < k:
        d = jnp.pad(d, ((0, 0), (0, k - d.shape[1])),
                    constant_values=jnp.inf)
        rows = jnp.pad(rows, ((0, 0), (0, k - rows.shape[1])))
    return merge_topk(-d, rows, k)


def _local_rerank(q, rows, valid, x, *, k, metric):
    """Per-device body: re-score the candidate rows THIS shard owns
    exactly, ``psum`` the keys (each valid row has exactly one owner;
    non-owners contribute 0), then a replicated top-k — the sharded
    analogue of :func:`...build._rerank_exact`, same inf-for-invalid and
    tie-break semantics."""
    nloc = x.shape[0]
    base = jax.lax.axis_index(AXIS) * nloc
    lrows = rows - base
    owned = valid & (lrows >= 0) & (lrows < nloc)
    cand = jnp.take(x, jnp.where(owned, lrows, 0), axis=0)  # [B, R, M]
    if metric == "dot":
        exact = -jnp.einsum("bm,brm->br", q, cand,
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)
    else:
        diff = cand - q[:, None, :]
        exact = jnp.sum(diff * diff, axis=-1)
    exact = jax.lax.psum(jnp.where(owned, exact, 0.0), AXIS)  # [B, R]
    exact = jnp.where(valid, exact, jnp.inf)
    neg, sel = jax.lax.top_k(-exact, k)
    return -neg, jnp.take_along_axis(rows, sel, axis=1)


@functools.partial(jax.jit, static_argnames=("mesh", "k", "metric"))
def rerank_sharded(q: jax.Array, rows: jax.Array, valid: jax.Array,
                   x: jax.Array, *, mesh: Mesh, k: int,
                   metric: str = "l2") -> tuple[jax.Array, jax.Array]:
    """Exact re-scoring of ADC candidates against a SHARDED raw corpus —
    the mesh analogue of the in-memory rerank (IVFPQ+refine, the recall
    knob single-chip serving gets from ``query(..., rerank=R)``).

    ``q [B, M]``, ``rows [B, R]`` candidate global corpus rows (e.g. the
    top-R of :func:`..parallel.query.query_sharded` /
    ``query_bucketed_sharded``), ``valid [B, R]`` bool (False where the
    ADC pass ran dry), ``x [N_pad, M]`` row-sharded originals
    (:func:`shard_flat`). Only the ``[B, R]`` candidate keys cross devices
    (one ``psum``) — never the gathered ``[B, R, M]`` vectors. Returns
    replicated ``(exact_keys [B, k], rows [B, k])``.
    """
    fn = jax.shard_map(
        functools.partial(_local_rerank, k=k, metric=metric),
        mesh=mesh,
        in_specs=(P(), P(), P(), P(AXIS, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(q, rows, valid, x)


@functools.partial(jax.jit, static_argnames=("mesh", "k", "n", "metric"))
def exact_sharded(q: jax.Array, x: jax.Array,
                  row_mask: jax.Array | None = None, *, mesh: Mesh, k: int,
                  n: int, metric: str = "l2") -> tuple[jax.Array, jax.Array]:
    """Exact k-NN with the corpus sharded across ``mesh``.

    ``x`` must be row-sharded (see :func:`shard_flat`); ``n`` is the true
    (unpadded) corpus size; ``row_mask [N_pad] bool`` (optional, attribute
    filtering) shards like the rows (:func:`..parallel.mesh.shard_mask`).
    Returns ``(sq_distances [B, k], rows [B, k])``.
    ``metric`` as in :mod:`..metrics` ("dot" keys are negated inner
    products — pad rows are zero vectors whose inner product is 0, which
    could outrank real negative-IP rows, hence the same ``rows < n`` mask).
    """
    nloc = x.shape[0] // mesh.devices.size
    n_pad = x.shape[0] - n
    kk = min(k + n_pad, nloc)
    has_mask = row_mask is not None
    extras = (row_mask,) if has_mask else ()
    especs = (P(AXIS),) if has_mask else ()
    fn = jax.shard_map(
        functools.partial(_local, k=k, kk=kk, n=n, metric=metric),
        mesh=mesh,
        in_specs=(P(), P(AXIS, None), *especs),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(q, x, *extras)


def _local_keys(q, x, *, n, metric):
    """Per-device exact keys for the local rows, gathered back to global
    column order (column ``j`` IS corpus row ``j``; pads ``+inf``)."""
    nloc = x.shape[0]
    base = jax.lax.axis_index(AXIS) * nloc
    if metric == "dot":
        keys = -jnp.matmul(q, x.T, precision=jax.lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)
    else:
        from ..ops.distance import sqdist
        keys = sqdist(q, x)                                # [B, nloc]
    rows = base + jnp.arange(nloc, dtype=jnp.int32)
    keys = jnp.where((rows < n)[None, :], keys, jnp.inf)
    return jax.lax.all_gather(keys, AXIS, axis=1, tiled=True)


@functools.partial(jax.jit, static_argnames=("mesh", "n", "metric"))
def exact_keys_sharded(q: jax.Array, x: jax.Array, *, mesh: Mesh, n: int,
                       metric: str = "l2") -> jax.Array:
    """Exact ranking keys of every corpus row, corpus sharded — the mesh
    analogue of the flat tier's full key scan (range search). Returns
    replicated ``[B, N_pad]`` (pad columns ``+inf``); the full key array
    crosses devices, inherent to range search."""
    fn = jax.shard_map(
        functools.partial(_local_keys, n=n, metric=metric),
        mesh=mesh,
        in_specs=(P(), P(AXIS, None)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(q, x)
