"""Joint nonlinear refinement of a loop/merge Sim3.

The reference refines the RANSAC/Horn loop Sim3 with a g2o LM solve over
both-direction reprojection edges (VertexSim3Expmap + EdgeSim3ProjectXYZ /
EdgeInverseSim3ProjectXYZ) with Huber kernels and a two-round inlier
re-toggle: optimize 5 iterations, drop edges with chi2 > 10, optimize 10
more (Optimizer::OptimizeSim3, src/Optimizer.cc:2115-2318).

Design: one fixed-capacity jitted LM. Residuals are a single
masked (4N,) vector — image-1 reprojections of cam2 points through S12
stacked with image-2 reprojections of cam1 points through S12^-1 — the
Jacobian comes from forward-mode AD of the Sim3 retraction at the identity,
Huber is an IRLS weight, and the inlier re-toggle is a mask update between
two `lax.fori_loop` rounds. Capacity buckets (powers of two) keep the
compile cache small.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_F = jnp.float32


class OptSim3Result(NamedTuple):
    success: bool
    s: float
    R: np.ndarray
    t: np.ndarray
    n_inliers: int
    inliers: np.ndarray  # (N,) bool over the input correspondences
    cost: float


def _so3_exp_j(phi):
    th2 = jnp.dot(phi, phi)
    th = jnp.sqrt(th2 + 1e-24)
    W = jnp.array([
        [0.0, -phi[2], phi[1]],
        [phi[2], 0.0, -phi[0]],
        [-phi[1], phi[0], 0.0],
    ], _F)
    a = jnp.where(th < 1e-5, 1.0 - th2 / 6.0, jnp.sin(th) / th)
    b = jnp.where(th < 1e-5, 0.5 - th2 / 24.0, (1.0 - jnp.cos(th)) / th2)
    return jnp.eye(3, dtype=_F) + a * W + b * (W @ W)


def _retract(xi, s, R, t):
    """Left-multiply the current estimate by the chart
    delta(xi) = (exp(sigma), exp_so3(phi), rho) — a valid local
    diffeomorphism at 0 (LM only needs a retraction, not the exact
    Sim3 exponential's W-Jacobian)."""
    rho, phi, sigma = xi[:3], xi[3:6], xi[6]
    ds = jnp.exp(sigma)
    dR = _so3_exp_j(phi)
    s_new = ds * s
    R_new = dR @ R
    t_new = ds * (dR @ t) + rho
    return s_new, R_new, t_new


def _residuals(s, R, t, X1, X2, uv1, uv2, K1, K2):
    """(N,2) image-1 residuals of S12·X2 and (N,2) image-2 residuals of
    S12^-1·X1 (EdgeSim3ProjectXYZ / EdgeInverseSim3ProjectXYZ)."""
    Y1 = s * (X2 @ R.T) + t                       # cam2 pts -> cam1 frame
    si = 1.0 / s
    Y2 = si * ((X1 - t) @ R)                      # cam1 pts -> cam2 frame

    def proj(K, X):
        z = jnp.maximum(X[:, 2], 1e-6)
        return jnp.stack([K[0, 0] * X[:, 0] / z + K[0, 2],
                          K[1, 1] * X[:, 1] / z + K[1, 2]], -1)

    r1 = uv1 - proj(K1, Y1)
    r2 = uv2 - proj(K2, Y2)
    bad1 = Y1[:, 2] <= 1e-3
    bad2 = Y2[:, 2] <= 1e-3
    big = jnp.float32(1e3)
    r1 = jnp.where(bad1[:, None], big, r1)
    r2 = jnp.where(bad2[:, None], big, r2)
    return r1, r2


def _chi2(r1, r2, w1, w2):
    return w1 * jnp.sum(r1 * r1, -1), w2 * jnp.sum(r2 * r2, -1)


@partial(jax.jit, static_argnames=("fix_scale", "iters1", "iters2"))
def _lm_rounds(X1, X2, uv1, uv2, K1, K2, w1, w2, valid, s0, R0, t0,
               th2, w_scale, fix_scale: bool, iters1: int = 5,
               iters2: int = 10):
    delta = jnp.sqrt(th2)
    sqrt_ws = jnp.sqrt(w_scale)
    log_s0 = jnp.log(s0)

    def huber_w(chi2):
        e = jnp.sqrt(chi2 + 1e-12)
        return jnp.where(e <= delta, 1.0, delta / e)

    def robust_cost(s, R, t, mask):
        r1, r2 = _residuals(s, R, t, X1, X2, uv1, uv2, K1, K2)
        c1, c2 = _chi2(r1, r2, w1, w2)

        def rho(c):
            # Huber cost: c if c<=th2 else 2*delta*sqrt(c)-th2
            return jnp.where(c <= th2, c, 2.0 * delta * jnp.sqrt(c) - th2)

        prior = w_scale * (jnp.log(s) - log_s0) ** 2
        return jnp.sum(mask * (rho(c1) + rho(c2))) + prior

    def lm_iter(_, carry):
        s, R, t, lam, mask = carry

        def f(xi):
            sn, Rn, tn = _retract(xi, s, R, t)
            r1, r2 = _residuals(sn, Rn, tn, X1, X2, uv1, uv2, K1, K2)
            # log-scale anchor to the 3D-3D (Horn) scale: reprojection-only
            # edges observe scale weakly when |t| << depth, so the RANSAC
            # scale estimate is retained as a prior instead of discarded
            r_s = sqrt_ws * (jnp.log(sn) - log_s0)
            return jnp.concatenate([r1.reshape(-1), r2.reshape(-1),
                                    r_s[None]])

        zero = jnp.zeros(7, _F)
        r0 = f(zero)
        J = jax.jacfwd(f)(zero)                       # (4N+1, 7)
        n2 = (r0.shape[0] - 1) // 2
        r1 = r0[:n2].reshape(-1, 2)
        r2 = r0[n2: 2 * n2].reshape(-1, 2)
        c1, c2 = _chi2(r1, r2, w1, w2)
        wr1 = (w1 * huber_w(c1) * mask)[:, None].repeat(2, 1).reshape(-1)
        wr2 = (w2 * huber_w(c2) * mask)[:, None].repeat(2, 1).reshape(-1)
        w = jnp.concatenate([wr1, wr2, jnp.ones(1, _F)])
        H = (J * w[:, None]).T @ J
        g = (J * w[:, None]).T @ r0
        if fix_scale:
            H = H.at[6, :].set(0.0).at[:, 6].set(0.0).at[6, 6].set(1.0)
            g = g.at[6].set(0.0)
        Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(7, dtype=_F)
        dx = -jnp.linalg.solve(Hd, g)
        sn, Rn, tn = _retract(dx, s, R, t)
        c_old = robust_cost(s, R, t, mask)
        c_new = robust_cost(sn, Rn, tn, mask)
        accept = (c_new < c_old) & jnp.all(jnp.isfinite(dx))
        s = jnp.where(accept, sn, s)
        R = jnp.where(accept, Rn, R)
        t = jnp.where(accept, tn, t)
        lam = jnp.where(accept, lam * 0.3, lam * 4.0)
        lam = jnp.clip(lam, 1e-8, 1e6)
        return s, R, t, lam, mask

    s, R, t, lam, mask = jax.lax.fori_loop(
        0, iters1, lm_iter, (s0, R0, t0, jnp.float32(1e-3), valid)
    )
    # inlier re-toggle (Optimizer.cc:2264-2285): a correspondence is dropped
    # when EITHER direction exceeds th2
    r1, r2 = _residuals(s, R, t, X1, X2, uv1, uv2, K1, K2)
    c1, c2 = _chi2(r1, r2, w1, w2)
    mask2 = valid & (c1 <= th2) & (c2 <= th2)
    s, R, t, lam, _ = jax.lax.fori_loop(
        0, iters2, lm_iter, (s, R, t, jnp.float32(1e-3), mask2)
    )
    r1, r2 = _residuals(s, R, t, X1, X2, uv1, uv2, K1, K2)
    c1, c2 = _chi2(r1, r2, w1, w2)
    inliers = valid & (c1 <= th2) & (c2 <= th2)
    return s, R, t, inliers, robust_cost(s, R, t, inliers)


def optimize_sim3(
    X1, X2, uv1, uv2, K1, K2, sigma2_1, sigma2_2,
    s0: float, R0, t0,
    fix_scale: bool = False, th2: float = 10.0, min_inliers: int = 10,
    w_scale_prior: float | None = None,
) -> OptSim3Result:
    """Refine S12 (X1 ≈ s R X2 + t) from `s0, R0, t0`.

    X1/X2: (N,3) points in camera-1 / camera-2 frames; uv1/uv2: (N,2) pixel
    observations in image 1 / image 2; sigma2_*: per-correspondence pyramid
    scale^2 (the reference's invSigmaSquare^-1). Returns the refined Sim3
    plus the surviving inlier mask."""
    X1 = np.asarray(X1, np.float32)
    n = len(X1)
    if n < 3:
        return OptSim3Result(False, float(s0), np.asarray(R0, np.float64),
                             np.asarray(t0, np.float64), 0,
                             np.zeros(n, bool), np.inf)
    cap = max(64, 1 << int(np.ceil(np.log2(n))))
    pad = cap - n

    def pz(a, fill=0.0):
        a = np.asarray(a, np.float32)
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill,
                                          np.float32)]) if pad else a

    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    if w_scale_prior is None:
        # anchor strength ~ the information the 3D-3D RANSAC scale carries:
        # strong enough that 1-px noise cannot drag the weakly-observable
        # scale around, proportional to n so a large consistent reprojection
        # signal can still overrule the prior (grid-validated: 2000*n keeps
        # scale at Horn accuracy while R/t improve 2-5x)
        w_scale_prior = 0.0 if fix_scale else 2000.0 * n
    s, R, t, inl, cost = _lm_rounds(
        jnp.asarray(pz(X1)), jnp.asarray(pz(X2, 1.0)),
        jnp.asarray(pz(uv1)), jnp.asarray(pz(uv2)),
        jnp.asarray(np.asarray(K1, np.float32)),
        jnp.asarray(np.asarray(K2, np.float32)),
        jnp.asarray(1.0 / np.maximum(pz(sigma2_1, 1.0), 1e-9)),
        jnp.asarray(1.0 / np.maximum(pz(sigma2_2, 1.0), 1e-9)),
        jnp.asarray(valid),
        jnp.float32(s0), jnp.asarray(np.asarray(R0, np.float32)),
        jnp.asarray(np.asarray(t0, np.float32)), jnp.float32(th2),
        jnp.float32(w_scale_prior), fix_scale,
    )
    inl = np.asarray(inl)[:n]
    ni = int(inl.sum())
    R_np = np.asarray(R, np.float64)
    # re-orthonormalize float32 drift
    U, _, Vt = np.linalg.svd(R_np)
    R_np = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    return OptSim3Result(
        ni >= min_inliers, float(s), R_np, np.asarray(t, np.float64),
        ni, inl, float(cost),
    )
