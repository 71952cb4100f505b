"""Sim(3) similarity transforms, batched and jit-safe.

Replaces Sophus::Sim3 (Thirdparty/Sophus/sophus/sim3.hpp) used by the
reference's loop closing / essential-graph optimization (LoopClosing.cc,
Optimizer.cc:1501) and Sim3Solver. Action: y = s R x + t.
Tangent convention [rho (3), phi (3), sigma (1)].
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fasttrack_tpu.geometry.so3 import hat, so3_exp, so3_log


def _mm(a, b):
    """3x3 matmuls in full f32: a reduced-precision default (TF32 on the
    GPU keeps ~3 decimal digits) corrupts rotation algebra. Pin HIGHEST."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _mv(A, x):
    return jnp.einsum("...ij,...j->...i", A, x, precision=jax.lax.Precision.HIGHEST)


_EPS = 1e-6


class Sim3(NamedTuple):
    R: jnp.ndarray  # (..., 3, 3)
    t: jnp.ndarray  # (..., 3)
    s: jnp.ndarray  # (...,)


def sim3_identity(batch_shape=(), dtype=jnp.float32) -> Sim3:
    return Sim3(
        jnp.broadcast_to(jnp.eye(3, dtype=dtype), (*batch_shape, 3, 3)),
        jnp.zeros((*batch_shape, 3), dtype=dtype),
        jnp.ones(batch_shape, dtype=dtype),
    )


def _calc_W(phi: jnp.ndarray, sigma: jnp.ndarray) -> jnp.ndarray:
    """The Sim3 'W' matrix such that t = W rho in sim3_exp.

    Closed form from Strasdat's thesis (as in Sophus sim3.hpp calcW), with
    small-angle / small-scale branches folded in via jnp.where.
    """
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    s = jnp.exp(sigma)
    sigma_small = jnp.abs(sigma) < _EPS
    theta_small = theta2 < _EPS * _EPS

    safe_sigma = jnp.where(sigma_small, 1.0, sigma)
    safe_theta = jnp.where(theta_small, 1.0, theta)
    safe_theta2 = safe_theta * safe_theta

    C = jnp.where(sigma_small, 1.0 + 0.5 * sigma, (s - 1.0) / safe_sigma)

    # sigma small branch
    A_ss = jnp.where(theta_small, 0.5, (1.0 - jnp.cos(safe_theta)) / safe_theta2)
    B_ss = jnp.where(
        theta_small, 1.0 / 6.0, (safe_theta - jnp.sin(safe_theta)) / (safe_theta2 * safe_theta)
    )

    # sigma large branch
    A_ls_t_small = ((safe_sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma)
    B_ls_t_small = (
        (0.5 * safe_sigma * safe_sigma - safe_sigma + 1.0) * s - 1.0
    ) / (safe_sigma * safe_sigma * safe_sigma)
    a = s * jnp.sin(safe_theta)
    b = s * jnp.cos(safe_theta)
    c = theta2 + sigma * sigma
    c = jnp.where(c < _EPS * _EPS, 1.0, c)
    A_ls_t_big = (a * safe_sigma + (1.0 - b) * safe_theta) / (safe_theta * c)
    B_ls_t_big = (C - ((b - 1.0) * sigma + a * safe_theta) / c) / safe_theta2
    A_ls = jnp.where(theta_small, A_ls_t_small, A_ls_t_big)
    B_ls = jnp.where(theta_small, B_ls_t_small, B_ls_t_big)

    A = jnp.where(sigma_small, A_ss, A_ls)
    B = jnp.where(sigma_small, B_ss, B_ls)

    K = hat(phi)
    KK = _mm(K, K)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return C[..., None, None] * eye + A[..., None, None] * K + B[..., None, None] * KK


def sim3_exp(xi: jnp.ndarray) -> Sim3:
    """(..., 7) [rho, phi, sigma] -> Sim3."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3_exp(phi)
    s = jnp.exp(sigma)
    W = _calc_W(phi, sigma)
    t = _mv(W, rho)
    return Sim3(R, t, s)


def sim3_log(S: Sim3) -> jnp.ndarray:
    phi = so3_log(S.R)
    sigma = jnp.log(S.s)
    W = _calc_W(phi, sigma)
    rho = jnp.linalg.solve(W, S.t[..., None])[..., 0]
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def sim3_inverse(S: Sim3) -> Sim3:
    Rt = jnp.swapaxes(S.R, -1, -2)
    s_inv = 1.0 / S.s
    t_inv = -s_inv[..., None] * _mv(Rt, S.t)
    return Sim3(Rt, t_inv, s_inv)


def sim3_compose(A: Sim3, B: Sim3) -> Sim3:
    return Sim3(
        _mm(A.R, B.R),
        A.s[..., None] * _mv(A.R, B.t) + A.t,
        A.s * B.s,
    )


def sim3_apply(S: Sim3, x: jnp.ndarray) -> jnp.ndarray:
    return S.s[..., None] * _mv(S.R, x) + S.t


def sim3_from_se3(T) -> Sim3:
    return Sim3(T.R, T.t, jnp.ones(T.t.shape[:-1], dtype=T.t.dtype))


def sim3_to_se3(S: Sim3):
    """Drop the scale into the translation (used when correcting keyframe
    poses after essential-graph optimization, LoopClosing.cc CorrectLoop:
    Tcw = [R, t/s])."""
    from fasttrack_tpu.geometry.se3 import SE3

    return SE3(S.R, S.t / S.s[..., None])
