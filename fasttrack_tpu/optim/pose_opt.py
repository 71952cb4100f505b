"""Motion-only pose optimization (the reference's Optimizer::PoseOptimization,
src/Optimizer.cc:814-1115).

Structure mirrored from the reference:
- 4 outer rounds x 10 LM iterations (`its[4]={10,10,10,10}`, Optimizer.cc:1003)
- after each round, edges are re-classified inlier/outlier by chi2 against
  5.991 (mono, 2dof) / 7.815 (stereo, 3dof) at the current pose
- rounds 0-1 use a Huber kernel, later rounds none (Optimizer.cc:1035)

Design: edges never leave the graph — outliers become zero-weight
masked residuals, so the whole optimization is one fixed-shape jitted
program: residual/Jacobian evaluation is a vmapped autodiff over N points
(XLA fuses it with the projection), the normal equations are a 6x6 solve.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from fasttrack_tpu.cameras.models import Camera, project
from fasttrack_tpu.geometry import SE3, se3_apply, se3_compose, se3_exp
from fasttrack_tpu.optim.robust import CHI2_MONO, CHI2_STEREO, huber_weight


class PoseOptResult(NamedTuple):
    pose: SE3
    inliers: jnp.ndarray      # (N,) bool
    n_inliers: jnp.ndarray    # () int32


def _residuals(T: SE3, cam: Camera, bf, Xw, obs_uv, obs_ur, is_stereo):
    """Per-point residual (3,): [du, dv, dur]; dur=0 for mono edges.

    Stereo edge = EdgeStereoSE3ProjectXYZOnlyPose (u_r = u - bf/z,
    OptimizableTypes.h / g2o sba stereo)."""
    Xc = se3_apply(T, Xw)
    uv = project(cam, Xc)
    z = jnp.maximum(Xc[..., 2], 1e-6)
    ur = uv[..., 0] - bf / z
    du = obs_uv[..., 0] - uv[..., 0]
    dv = obs_uv[..., 1] - uv[..., 1]
    dur = jnp.where(is_stereo, obs_ur - ur, 0.0)
    return jnp.stack([du, dv, dur], axis=-1)


@functools.partial(jax.jit, static_argnames=("rounds", "iters"))
def pose_optimize(
    cam: Camera,
    bf: jnp.ndarray,
    T0: SE3,                 # initial Tcw
    Xw: jnp.ndarray,         # (N, 3) world points
    obs_uv: jnp.ndarray,     # (N, 2) observed pixels
    obs_ur: jnp.ndarray,     # (N,) observed right-u; < 0 => mono edge
    inv_sigma2: jnp.ndarray, # (N,) information scale (1/sigma^2 of the level)
    valid: jnp.ndarray,      # (N,) bool
    rounds: int = 4,
    iters: int = 10,
) -> PoseOptResult:
    is_stereo = obs_ur >= 0

    def chi2_fn(T, mask_unused=None):
        r = _residuals(T, cam, bf, Xw, obs_uv, obs_ur, is_stereo)
        return jnp.sum(r * r, axis=-1) * inv_sigma2  # (N,)

    def jacobian(T):
        # ONE jacfwd over the 6-dim tangent of the FULL residual stack
        # (6 vectorized JVP passes). The per-point vmap(jacfwd) form traces
        # the residual once per point and compiled ~10x slower for identical
        # output.
        def res_of_xi(xi):
            Tp = se3_compose(se3_exp(xi), T)
            return _residuals(Tp, cam, bf, Xw, obs_uv, obs_ur, is_stereo)

        return jax.jacfwd(res_of_xi)(jnp.zeros(6, dtype=Xw.dtype))  # (N, 3, 6)

    def lm_round(T, inlier_mask, use_robust, n_iters):
        delta2 = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)

        def body(carry, _):
            T, lam = carry
            r = _residuals(T, cam, bf, Xw, obs_uv, obs_ur, is_stereo)  # (N,3)
            chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2
            w_rob = jnp.where(use_robust, huber_weight(chi2, delta2), 1.0)
            w = w_rob * inv_sigma2 * inlier_mask
            J = jacobian(T)  # (N, 3, 6)
            H = jnp.einsum("nij,nik,n->jk", J, J, w)
            g = jnp.einsum("nij,ni,n->j", J, r, w)
            # J is d(residual)/d(xi) where residual = obs - proj, so the
            # Gauss-Newton step solves (H + lam D) dx = -g ... with r defined
            # as obs-pred and J = dr/dxi, normal equations: H dx = -g.
            D = jnp.diag(jnp.diag(H))
            dx = jnp.linalg.solve(H + lam * D + 1e-9 * jnp.eye(6), -g)
            T_new = se3_compose(se3_exp(dx), T)
            c_old = jnp.sum(chi2 * w_rob * inlier_mask)
            r_new = _residuals(T_new, cam, bf, Xw, obs_uv, obs_ur, is_stereo)
            chi2_new = jnp.sum(r_new * r_new, axis=-1) * inv_sigma2
            w_rob_new = jnp.where(use_robust, huber_weight(chi2_new, delta2), 1.0)
            c_new = jnp.sum(chi2_new * w_rob_new * inlier_mask)
            accept = c_new < c_old
            T = jax.tree_util.tree_map(
                lambda a, b: jnp.where(accept, a, b), T_new, T
            )
            lam = jnp.where(accept, lam * 0.5, lam * 4.0)
            return (T, lam), None

        (T, _), _ = jax.lax.scan(body, (T, jnp.asarray(1e-3, Xw.dtype)), None, length=n_iters)
        return T

    T = T0
    inlier = valid.astype(Xw.dtype)
    for rnd in range(rounds):
        use_robust = rnd < 2  # Optimizer.cc:1035 drops the kernel after 2 rounds
        T = lm_round(T, inlier, use_robust, iters)
        chi2 = chi2_fn(T)
        thr = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
        inlier = (valid & (chi2 <= thr)).astype(Xw.dtype)

    inl = inlier > 0
    return PoseOptResult(T, inl, jnp.sum(inl.astype(jnp.int32)))
