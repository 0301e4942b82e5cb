"""Vector containers.

The reference stores vectors in a contiguous block (``src/vector.rs:29-100``
``BlockVectorSet``) with zero-copy column-slice views (``SubVectorSet``,
``vector.rs:103-149``) and a ``divide_vector_set`` helper that splits the
feature dimension into ``d`` equal column blocks for product quantization
(``vector.rs:154-174``).

Device-first representation: a vector set *is* a dense ``[N, M]`` array (numpy on
the host, ``jax.Array`` on device). Sub-vector division is a reshape —
``x.reshape(N, D, M // D)`` — no view machinery needed; per-division work is a
``vmap``/leading-batch-axis over ``D``. This module keeps only the thin
validation layer (chunk/divide semantics and their error cases) so the rest of
the library can operate on plain arrays.
"""

from __future__ import annotations

import warnings
from typing import Union

import numpy as np

from .errors import InvalidArgs

Array = Union[np.ndarray, "jax.Array"]  # noqa: F821 - jax imported lazily


def as_vector_set(data: Array, vector_size: int | None = None) -> np.ndarray:
    """Coerces ``data`` into an ``[N, M]`` float32 vector-set array.

    Accepts either a 2-D array (used as-is) or a flat 1-D buffer plus
    ``vector_size`` which is chunked row-wise — the equivalent of
    ``BlockVectorSet::chunk`` (``vector.rs:40-57``), including its error case:
    the flat length must be a multiple of ``vector_size``.

    dtype policy (the reference's number-trait layer makes the stack
    f32/f64-generic with only f32 implemented, ``numbers.rs:6-111``,
    ``README.md:54,63``): f64 (and integer) input is ACCEPTED with a
    *checked* cast to f32 — finite values that would overflow to ``±inf``
    raise :class:`InvalidArgs` instead of silently corrupting distances.
    The device path is f32; :mod:`flechasdb_tpu.oracle` is the
    f64-capable host path. Documented divergence: see PARITY.md.
    """
    arr = np.asarray(data)
    if arr.dtype != np.float32:
        if not (np.issubdtype(arr.dtype, np.floating)
                or np.issubdtype(arr.dtype, np.integer)):
            raise InvalidArgs(f"unsupported vector dtype: {arr.dtype}")
        with np.errstate(over="ignore"), warnings.catch_warnings():
            # Overflow is detected and reported below as InvalidArgs;
            # numpy's cast warning would be redundant noise.
            warnings.simplefilter("ignore", RuntimeWarning)
            cast = arr.astype(np.float32)
        if arr.dtype.itemsize > 4:
            bad = np.isinf(cast) & np.isfinite(
                arr.astype(np.float64, copy=False))
            if bad.any():
                raise InvalidArgs(
                    "vector values exceed the float32 range "
                    f"(first at flat index {int(np.flatnonzero(bad)[0])}); "
                    "the device path is f32 — rescale or use "
                    "flechasdb_tpu.oracle for an f64 host path")
        arr = cast
    if arr.ndim == 1:
        if vector_size is None:
            raise InvalidArgs("vector_size is required to chunk a flat buffer")
        if vector_size <= 0:
            raise InvalidArgs(f"vector_size must be positive: {vector_size}")
        if arr.size % vector_size != 0:
            raise InvalidArgs(
                f"data size ({arr.size}) is not a multiple of vector size"
                f" ({vector_size})"
            )
        arr = arr.reshape(-1, vector_size)
    elif arr.ndim == 2:
        if vector_size is not None and arr.shape[1] != vector_size:
            raise InvalidArgs(
                f"vector_size {vector_size} does not match array width"
                f" {arr.shape[1]}"
            )
    else:
        raise InvalidArgs(f"vector set must be 1-D or 2-D, got {arr.ndim}-D")
    return np.ascontiguousarray(arr)


def divide_vector_set(x: Array, d: int) -> Array:
    """Splits the feature dimension into ``d`` equal column blocks.

    Returns a ``[D, N, M // D]`` array (division-major so each division is a
    contiguous batch entry for batched PQ training). Equivalent to
    ``divide_vector_set`` (``vector.rs:154-174``) including the error when
    ``M`` is not a multiple of ``d``.
    """
    if d <= 0:
        raise InvalidArgs(f"number of divisions must be positive: {d}")
    n, m = x.shape
    if m % d != 0:
        raise InvalidArgs(
            f"vector size ({m}) is not divisible by {d}"
        )
    # [N, M] -> [N, D, m] -> [D, N, m]
    return x.reshape(n, d, m // d).transpose(1, 0, 2)
