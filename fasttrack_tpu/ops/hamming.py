"""Hamming distance between binary descriptors — as int8 matmuls.

Parity target: CudaUtils.cu:42-56 (__device__ DescriptorDistance, popcount
over 8 uint32 words) and ORBmatcher.cc:2256 (CPU popcount).

Design: a binary descriptor d in {0,1}^256 is stored as a signed vector
s = 2d-1 in int8. For two descriptors,
    <s1, s2> = 256 - 2 * hamming(d1, d2)
so a full (N, M) Hamming matrix is ONE int8 matmul with int32 accumulation
(exact) — this replaces every per-pair popcount loop in the reference's
matching kernels. On the GPU, XLA compiles it as a GEMM.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

N_BITS = 256


def signed_descriptors(bits: jnp.ndarray) -> jnp.ndarray:
    """(N, 256) {0,1} -> (N, 256) int8 in {-1, +1}."""
    return (2 * bits.astype(jnp.int8) - 1).astype(jnp.int8)


def hamming_matrix(s1: jnp.ndarray, s2: jnp.ndarray) -> jnp.ndarray:
    """Signed descriptors (N, 256) x (M, 256) -> (N, M) int32 Hamming."""
    dot = jax.lax.dot_general(
        s1,
        s2,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
        precision=jax.lax.Precision.DEFAULT,  # int8: exact at any precision
    )
    return (N_BITS - dot) // 2


def hamming_matrix_f32(s1: jnp.ndarray, s2: jnp.ndarray) -> jnp.ndarray:
    """(N, M) Hamming distances as float32 (values are exact integers <=256).

    The matchers add float penalties to this matrix and take top-k / argmin
    over it, so they work in f32; distances are exact."""
    dot = jax.lax.dot_general(
        s1,
        s2,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
        precision=jax.lax.Precision.DEFAULT,  # int8: exact at any precision
    )
    return ((N_BITS - dot) // 2).astype(jnp.float32)


def hamming_matrix_packed(p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Host (NumPy) fallback on packed (N, 32) uint8 descriptors — the
    CPU path of the offload toggles."""
    x = np.bitwise_xor(p1[:, None, :], p2[None, :, :])
    return np.unpackbits(x, axis=-1).sum(axis=-1).astype(np.int32)
