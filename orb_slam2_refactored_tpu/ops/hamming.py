"""Packed-descriptor Hamming distance: the single matching core.

Capability analog of `ORBmatcher::DescriptorDistance`
(`/root/reference/src/ORBmatcher.cc:1449-1457`, popcount Hamming on 256-bit
descriptors) — realized as one bf16 matmul of +-1 bit vectors, batched into
full candidate matrices. Every matcher variant in the reference
(`SearchByProjection` x4, `SearchByBoW` x2, `SearchForInitialization`,
`SearchForTriangulation`, `SearchBySim3`, `Fuse` x2) reduces to this matrix
with a different candidate mask. Thresholds TH_LOW=50 / TH_HIGH=100
(`src/ORBmatcher.cc:41-42`) apply unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TH_LOW = 50
TH_HIGH = 100
BIG = 10_000  # sentinel distance for masked-out candidates (> 256 max)


def _pm1_bits(x):
    """u32[M,8] packed descriptors -> bf16[M,256] in {+1,-1} (bit 0 -> +1)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (x[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    pm1 = 1.0 - 2.0 * bits.astype(jnp.float32)
    return pm1.reshape(x.shape[0], 256).astype(jnp.bfloat16)


def hamming_matrix(a, b):
    """a: u32[M,8], b: u32[N,8] -> i32[M,N] Hamming distances.

    popcount(a XOR b) == (256 - dot(pm1(a), pm1(b))) / 2, with pm1 mapping
    bits to +-1. The dot is a sum of 256 terms in {+1,-1}: exact in bf16
    with f32 accumulation, so this is bit-identical to XOR + popcount, and
    on the H100 it runs on the tensor cores. Chosen over XOR +
    `bitwise_count` by timing both on the card at the matcher's and the
    vocabulary quantize's shapes (PERF.md)."""
    d = jax.lax.dot_general(
        _pm1_bits(a), _pm1_bits(b),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return ((256.0 - d) * 0.5).astype(jnp.int32)


def hamming_pairwise(a, b):
    """Row-wise distance for aligned pairs: u32[...,8] x u32[...,8] -> i32[...]."""
    x = jnp.bitwise_xor(a, b)
    return jnp.sum(jnp.bitwise_count(x).astype(jnp.int32), axis=-1)


def masked_best2(dist, mask):
    """Best and second-best along axis 1 under a boolean mask.

    dist: i32[M,N]; mask: bool[M,N]. Returns (best_idx i32[M], best i32[M],
    second i32[M]); masked-out entries read as BIG.
    """
    d = jnp.where(mask, dist, BIG)
    best_idx = jnp.argmin(d, axis=1)
    best = jnp.min(d, axis=1)
    d2 = d.at[jnp.arange(d.shape[0]), best_idx].set(BIG)
    second = jnp.min(d2, axis=1)
    return best_idx, best, second


def mutual_filter(idx_ab, idx_ba):
    """bool[M]: a->b assignment that is also b's choice (mutual NN)."""
    back = idx_ba[idx_ab]
    return back == jnp.arange(idx_ab.shape[0])


def resolve_duplicates(target_idx, dist, valid, n_targets: int):
    """Keep, per claimed target, only the claimant with smallest distance.

    Replaces the reference's sequential 'if already matched, keep better'
    bookkeeping (e.g. `src/ORBmatcher.cc:345-378`) with a scatter-min.
    target_idx: i32[M] target per row; dist: i32[M]; valid: bool[M].
    Returns bool[M] keep-mask.
    """
    d = jnp.where(valid, dist, BIG)
    best_per_target = jnp.full((n_targets,), BIG, jnp.int32).at[target_idx].min(d)
    # a row survives if it equals the winner distance; break remaining ties by
    # keeping the lowest row index
    is_best = valid & (d == best_per_target[target_idx])
    m = target_idx.shape[0]
    rows = jnp.arange(m)
    first_best_row = jnp.full((n_targets,), m, jnp.int32).at[target_idx].min(
        jnp.where(is_best, rows, m)
    )
    return is_best & (first_best_row[target_idx] == rows)
