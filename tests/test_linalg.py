"""Ports the reference linalg edge-case semantics (src/linalg.rs:365-869).

The reference tests each kernel at sizes below/at/above/straddling its 16-wide
unroll; on the device there is no unroll so we test a representative size sweep plus
the semantic edges: empty inputs, zero vectors, and the norm2 overflow
prescaling at 1e±30/36.
"""

import numpy as np
import pytest

from flechasdb_tpu.ops import linalg


SIZES = [1, 15, 16, 17, 33, 128, 1000]


@pytest.mark.parametrize("n", SIZES)
def test_dot_matches_numpy(rng, n):
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    assert np.allclose(linalg.dot(a, b), np.dot(a, b), rtol=1e-5)


def test_dot_empty_is_zero():
    assert float(linalg.dot(np.zeros(0, np.float32),
                            np.zeros(0, np.float32))) == 0.0


@pytest.mark.parametrize("n", SIZES)
def test_norm2_matches_numpy(rng, n):
    v = rng.standard_normal(n).astype(np.float32)
    assert np.allclose(linalg.norm2(v), np.linalg.norm(v), rtol=1e-5)


def test_norm2_zero_vector():
    assert float(linalg.norm2(np.zeros(8, np.float32))) == 0.0


def test_norm2_empty_is_zero():
    assert float(linalg.norm2(np.zeros(0, np.float32))) == 0.0


def test_norm2_huge_values_do_not_overflow():
    # linalg.rs prescales by max_abs so 1e30-magnitude entries survive f32.
    v = np.full(16, 1e30, np.float32)
    expected = 1e30 * np.sqrt(16.0)
    assert np.allclose(float(linalg.norm2(v)), expected, rtol=1e-5)
    naive = np.sqrt(np.sum(v.astype(np.float32) ** 2))  # overflows to inf
    assert np.isinf(naive)


def test_norm2_tiny_values():
    v = np.full(4, 1e-30, np.float32)
    assert np.allclose(float(linalg.norm2(v)), 2e-30, rtol=1e-5)


@pytest.mark.parametrize("n", SIZES)
def test_elementwise_ops(rng, n):
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    assert np.allclose(linalg.add(a, b), a + b)
    assert np.allclose(linalg.subtract(a, b), a - b)
    assert np.allclose(linalg.scale(a, 2.5), a * 2.5)


@pytest.mark.parametrize("n", SIZES)
def test_reductions(rng, n):
    v = rng.standard_normal(n).astype(np.float32)
    assert np.allclose(linalg.sum_(v), np.sum(v), rtol=1e-5, atol=1e-6)
    assert np.allclose(linalg.min_(v), np.min(v))
    assert np.allclose(linalg.max_abs(v), np.max(np.abs(v)))


def test_reductions_empty():
    e = np.zeros(0, np.float32)
    assert float(linalg.sum_(e)) == 0.0
    assert np.isinf(float(linalg.min_(e)))
    assert float(linalg.max_abs(e)) == 0.0
