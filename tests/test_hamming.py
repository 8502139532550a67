"""The single Hamming form against a numpy popcount oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orb_slam2_refactored_tpu.ops import hamming

LUT = np.array([bin(i).count("1") for i in range(256)], np.int32)


def popcount_oracle(a, b):
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    return LUT[x.view(np.uint8)].sum(-1)


def _ham(a, b):
    return np.asarray(jax.jit(hamming.hamming_matrix)(jnp.asarray(a),
                                                      jnp.asarray(b)))


@pytest.mark.parametrize("m,n", [(1, 1), (7, 13), (33, 5), (64, 129)])
def test_matches_popcount_oracle(m, n):
    """Random descriptors, M and N not multiples of 8."""
    rng = np.random.default_rng(m * 1000 + n)
    a = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    d = _ham(a, b)
    assert d.dtype == np.int32 and d.shape == (m, n)
    np.testing.assert_array_equal(d, popcount_oracle(a, b))


def test_extremes_and_single_bits():
    """All-zero vs all-ones is 256, identical rows are 0, and each single
    set bit is at distance 1 from zero and 255 from all-ones."""
    zeros = np.zeros((1, 8), np.uint32)
    ones = np.full((1, 8), 0xFFFFFFFF, np.uint32)
    singles = np.zeros((256, 8), np.uint32)
    for i in range(256):
        singles[i, i // 32] = np.uint32(1) << np.uint32(i % 32)
    a = np.concatenate([zeros, ones, singles])
    d = _ham(a, np.concatenate([zeros, ones]))
    assert d[0, 0] == 0 and d[1, 1] == 0
    assert d[0, 1] == 256 and d[1, 0] == 256
    np.testing.assert_array_equal(d[2:, 0], 1)
    np.testing.assert_array_equal(d[2:, 1], 255)
    # two distinct single bits differ in exactly two places
    ds = _ham(singles, singles)
    np.testing.assert_array_equal(ds, 2 * (1 - np.eye(256, dtype=np.int32)))


def test_pairwise_agrees_with_matrix_diagonal():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2 ** 32, (37, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (37, 8), dtype=np.uint32)
    pw = np.asarray(hamming.hamming_pairwise(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(pw, np.diag(popcount_oracle(a, b)))


@pytest.mark.gpu
def test_bit_exact_on_gpu_at_matcher_shape(gpu_device):
    """The whole-map matcher's [1000 x 32768] shape, compiled for the card."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 2 ** 32, (1000, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (32768, 8), dtype=np.uint32)
    with jax.default_device(gpu_device):
        d = _ham(a, b)
    ref = np.concatenate([popcount_oracle(a[s:s + 50], b)
                          for s in range(0, 1000, 50)])
    np.testing.assert_array_equal(d, ref)
