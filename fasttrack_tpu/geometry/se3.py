"""SE(3) rigid transforms as (R, t) pytrees, batched and jit-safe.

Replaces Sophus::SE3f (Thirdparty/Sophus/sophus/se3.hpp) used throughout the
reference for frame poses (Frame.h mTcw etc.). Tangent convention
[rho (trans), phi (rot)], matching Sophus.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fasttrack_tpu.geometry.so3 import (
    hat,
    so3_exp,
    so3_left_jacobian,
    so3_left_jacobian_inv,
    so3_log,
)


def _mm(a, b):
    """3x3 matmuls in full f32: a reduced-precision default (TF32 on the
    GPU keeps ~3 decimal digits) corrupts rotation algebra. Pin HIGHEST."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _mv(A, x):
    """Batched matrix-vector with exact accumulation (same rationale)."""
    return jnp.einsum("...ij,...j->...i", A, x, precision=jax.lax.Precision.HIGHEST)


class SE3(NamedTuple):
    """Rigid transform y = R x + t. R: (..., 3, 3), t: (..., 3)."""

    R: jnp.ndarray
    t: jnp.ndarray


def se3_identity(batch_shape=(), dtype=jnp.float32) -> SE3:
    R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (*batch_shape, 3, 3))
    t = jnp.zeros((*batch_shape, 3), dtype=dtype)
    return SE3(R, t)


def se3_exp(xi: jnp.ndarray) -> SE3:
    """(..., 6) [rho, phi] -> SE3."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    t = _mv(V, rho)
    return SE3(R, t)


def se3_log(T: SE3) -> jnp.ndarray:
    phi = so3_log(T.R)
    Vinv = so3_left_jacobian_inv(phi)
    rho = _mv(Vinv, T.t)
    return jnp.concatenate([rho, phi], axis=-1)


def se3_inverse(T: SE3) -> SE3:
    Rt = jnp.swapaxes(T.R, -1, -2)
    return SE3(Rt, -_mv(Rt, T.t))


def se3_compose(A: SE3, B: SE3) -> SE3:
    """A ∘ B (apply B first)."""
    return SE3(_mm(A.R, B.R), _mv(A.R, B.t) + A.t)


def se3_apply(T: SE3, x: jnp.ndarray) -> jnp.ndarray:
    """Transform points x (..., 3)."""
    return _mv(T.R, x) + T.t


def se3_matrix(T: SE3) -> jnp.ndarray:
    """(..., 4, 4) homogeneous matrix."""
    batch = T.t.shape[:-1]
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=T.t.dtype), (*batch, 1, 4)
    )
    top = jnp.concatenate([T.R, T.t[..., None]], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def se3_from_matrix(M: jnp.ndarray) -> SE3:
    return SE3(M[..., :3, :3], M[..., :3, 3])


def se3_adjoint(T: SE3) -> jnp.ndarray:
    """(..., 6, 6) adjoint: Ad_T = [[R, t^ R], [0, R]]."""
    tR = _mm(hat(T.t), T.R)
    zeros = jnp.zeros_like(T.R)
    top = jnp.concatenate([T.R, tR], axis=-1)
    bot = jnp.concatenate([zeros, T.R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def se3_boxplus(T: SE3, xi: jnp.ndarray) -> SE3:
    """Left-multiplicative update exp(xi) ∘ T — the optimizer retraction."""
    return se3_compose(se3_exp(xi), T)
