"""Dense linear-algebra primitives.

The reference hand-unrolls these 16-wide for CPU SIMD (``src/linalg.rs``).
On the device every one of them is a single fused XLA op, so this module is mostly a
semantic contract: it pins down the edge-case behaviour the reference's 42
unit tests encode (empty inputs, the overflow-safe ``norm2`` prescaling at
``linalg.rs:61-75``, min/max on empty slices) so higher layers can rely on it.

All functions accept numpy or jax arrays and stay in whatever namespace the
input lives in when practical; they are trace-safe under ``jax.jit``.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a, b):
    """Inner product (``linalg.rs:12-40``). Empty inputs yield 0."""
    return jnp.sum(jnp.asarray(a) * jnp.asarray(b), axis=-1)


def norm2(v):
    """Euclidean norm with overflow-safe prescaling (``linalg.rs:61-75``).

    The reference divides by ``max_abs`` before squaring so that vectors with
    entries near ``1e36`` (f32) do not overflow to inf; a zero vector yields 0.
    """
    v = jnp.asarray(v)
    if v.shape[-1] == 0:
        return jnp.zeros(v.shape[:-1], dtype=v.dtype)
    s = jnp.max(jnp.abs(v), axis=-1, keepdims=True)
    scaled = v / jnp.where(s > 0, s, 1)
    return jnp.squeeze(s, -1) * jnp.sqrt(jnp.sum(scaled * scaled, axis=-1))


def subtract(a, b):
    """Elementwise ``a - b`` (``linalg.rs:166-184``)."""
    return jnp.asarray(a) - jnp.asarray(b)


def add(a, b):
    """Elementwise ``a + b`` (``linalg.rs:149-163``)."""
    return jnp.asarray(a) + jnp.asarray(b)


def scale(v, s):
    """Elementwise ``v * s`` (``linalg.rs:187-203``)."""
    return jnp.asarray(v) * s


def sum_(v):
    """Sum of all elements (``linalg.rs:208-230``). Empty ⇒ 0."""
    return jnp.sum(jnp.asarray(v), axis=-1)


def min_(v):
    """Minimum element (``linalg.rs:233-289``). Empty ⇒ +inf."""
    v = jnp.asarray(v)
    if v.shape[-1] == 0:
        return jnp.full(v.shape[:-1], jnp.inf, dtype=v.dtype)
    return jnp.min(v, axis=-1)


def max_abs(v):
    """Maximum absolute element (``linalg.rs:292-345``). Empty ⇒ 0."""
    v = jnp.asarray(v)
    if v.shape[-1] == 0:
        return jnp.zeros(v.shape[:-1], dtype=v.dtype)
    return jnp.max(jnp.abs(v), axis=-1)
