"""SO(3): rotation-matrix Lie group ops, batched and jit-safe.

Replaces the reference's Sophus SO3 usage (Thirdparty/Sophus/sophus/so3.hpp)
and the right-Jacobian helpers in ImuTypes (src/ImuTypes.cc, IntegratedRotation
ImuTypes.h:129-140). All small-angle branches use Taylor expansions selected
with jnp.where so gradients stay finite under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def _mm(a, b):
    """3x3 matmuls in full f32: a reduced-precision default (TF32 on the
    GPU keeps ~3 decimal digits) corrupts rotation algebra. Pin HIGHEST."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def hat(phi: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(Phi: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) skew -> (..., 3)."""
    return jnp.stack([Phi[..., 2, 1], Phi[..., 0, 2], Phi[..., 1, 0]], axis=-1)


def _sinc_coeffs(theta2: jnp.ndarray):
    """Stable (A, B, C) with A=sin(t)/t, B=(1-cos t)/t^2, C=(1-A)/t^2."""
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    return a, b, c


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: (..., 3) tangent -> (..., 3, 3) rotation."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    a, b, _ = _sinc_coeffs(theta2)
    K = hat(phi)
    KK = _mm(K, K)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) rotation -> (..., 3) tangent. Handles theta near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # arccos' blows up at +-1 (d/dc = -1/sqrt(1-c^2)); the inertial residual
    # (optim.inertial) differentiates through so3_log at near-identity
    # rotations, and jacfwd propagates the inf through BOTH where-branches.
    # Clip the arccos input so the derivative stays finite; the small/near-pi
    # branches below already own those regimes value-wise.
    theta = jnp.arccos(jnp.clip(cos_theta, -1.0 + 1e-7, 1.0 - 1e-7))
    w = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # sin(theta) * axis

    # Generic branch: phi = theta / sin(theta) * w  (stable away from 0, pi).
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, _EPS * _EPS))
    small = theta < 1e-3  # clipped arccos floors theta at ~4.5e-4
    factor = jnp.where(small, 1.0 + theta * theta / 6.0, theta / sin_theta)
    phi_generic = factor[..., None] * w

    # Near pi: axis from the diagonal of (R + I)/2 = aa^T(1-cos)+..., use
    # the largest diagonal element for numerical stability.
    near_pi = cos_theta < -1.0 + 1e-5
    S = 0.5 * (R + jnp.swapaxes(R, -1, -2))  # = I cos + aa^T (1 - cos)
    diag = jnp.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], axis=-1)
    axis2 = jnp.clip((diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None]), 0.0, 1.0)
    axis_abs = jnp.sqrt(axis2)
    # Fix signs using off-diagonals of S relative to the dominant axis.
    k = jnp.argmax(axis_abs, axis=-1)

    def signed_axis(S, axis_abs, k):
        # sign(axis_i) relative to the dominant axis_k: sign(S[k, i]) since
        # S[k, i] = a_k a_i (1 - cos) for i != k; the dominant component is
        # forced positive (S[k, k] = cos + a_k^2(1-cos) may itself be < 0).
        skrow = jnp.take_along_axis(S, k[..., None, None].repeat(3, axis=-1), axis=-2)[
            ..., 0, :
        ]
        sign = jnp.where(skrow >= 0.0, 1.0, -1.0)
        is_dominant = (
            jax.lax.broadcasted_iota(jnp.int32, sign.shape, sign.ndim - 1)
            == k[..., None]
        )
        sign = jnp.where(is_dominant, 1.0, sign)
        return axis_abs * sign

    axis = signed_axis(S, axis_abs, k)
    norm = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    axis = axis / jnp.maximum(norm, _EPS)
    phi_pi = theta[..., None] * axis
    return jnp.where(near_pi[..., None], phi_pi, phi_generic)


def so3_left_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """J_l(phi): exp((phi+dphi)^) ~= exp(J_l dphi ^) exp(phi^)."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    _, b, c = _sinc_coeffs(theta2)
    K = hat(phi)
    KK = _mm(K, K)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + b[..., None, None] * K + c[..., None, None] * KK


def so3_right_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """J_r(phi) = J_l(-phi). Matches IMU::RightJacobianSO3 (ImuTypes.cc)."""
    return so3_left_jacobian(-phi)


def so3_left_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    half = 0.5 * theta
    small = theta2 < _EPS
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.maximum(jnp.sin(half), _EPS)) / theta2,
    )
    K = hat(phi)
    KK = _mm(K, K)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye - 0.5 * K + cot_term[..., None, None] * KK


def so3_right_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    """Inverse right Jacobian. Matches IMU::InverseRightJacobianSO3."""
    return so3_left_jacobian_inv(-phi)


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (..., 4) [w, x, y, z] -> rotation matrix (..., 3, 3)."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = jnp.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1
    )
    row1 = jnp.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1
    )
    row2 = jnp.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1
    )
    return jnp.stack([row0, row1, row2], axis=-2)


def matrix_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) [w, x, y, z].

    Branch-free Shepperd-style method: compute all four candidate quaternions
    and select the one keyed to the largest of (trace, R00, R11, R22).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    keys = jnp.stack([tr, m00, m11, m22], axis=-1)
    idx = jnp.argmax(keys, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4, 4)
    q = jnp.take_along_axis(cands, idx[..., None, None].repeat(4, axis=-1), axis=-2)[
        ..., 0, :
    ]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # Canonicalize sign: w >= 0.
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def normalize_rotation(R: jnp.ndarray) -> jnp.ndarray:
    """Project a near-rotation matrix back onto SO(3) (ImuTypes
    NormalizeRotation semantics) via SVD."""
    u, _, vt = jnp.linalg.svd(R)
    Rn = _mm(u, vt)
    # Fix possible reflection.
    det = jnp.linalg.det(Rn)
    u = u.at[..., :, -1].multiply(jnp.where(det < 0, -1.0, 1.0)[..., None])
    return _mm(u, vt)
