"""Visual-inertial optimization: motion-only VI pose optimization and the
temporal-window local inertial BA.

Parity targets:
- Optimizer::PoseInertialOptimizationLastKeyFrame / LastFrame
  (src/Optimizer.cc:4491, :4875): optimize the current frame's body state
  (pose, velocity, biases) against (a) masked visual reprojection edges
  (EdgeMonoOnlyPose/EdgeStereoOnlyPose, G2oTypes.h) and (b) one EdgeInertial
  (G2oTypes.h:495) to the previous keyframe/frame state, plus bias
  random-walk priors (EdgePriorGyro/EdgePriorAcc).
- Optimizer::LocalInertialBA (src/Optimizer.cc:2383): temporal window of
  recent keyframes with per-KF (pose, velocity, bias) states, inertial edges
  between consecutive KFs, visual edges to the window map points.

Design: everything is fixed-shape and jitted. Outlier handling is
the reference's chi2 re-classification between rounds (4 rounds, masked
residuals instead of graph surgery). The 15-dim state tangent is
[dphi, dp, dv, dbg, dba] with the reference's retraction
(ImuCamPose::Update, G2oTypes.cc): R <- R expSO3(dphi), p <- p + R dp.
Jacobians come from jax.jacfwd through the full residual stack; the normal
equations are a dense 15x15 (motion-only) or Schur-reduced K*15 solve —
both tiny; the FLOPs live in the vmapped visual residuals, which XLA
fuses.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from fasttrack_tpu.cameras.models import Camera, project
from fasttrack_tpu.geometry.so3 import so3_exp, so3_log
from fasttrack_tpu.imu.preintegration import GRAVITY, ImuBias, Preintegrated
from fasttrack_tpu.optim.robust import CHI2_MONO, CHI2_STEREO, huber_weight


def _mm(a, b):
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _mv(A, x):
    return jnp.einsum("...ij,...j->...i", A, x, precision=jax.lax.Precision.HIGHEST)


class BodyState(NamedTuple):
    """IMU body state in the world frame (VertexPose+VertexVelocity+biases)."""

    R_wb: jnp.ndarray  # (..., 3, 3)
    p_w: jnp.ndarray   # (..., 3)
    v_w: jnp.ndarray   # (..., 3)
    bg: jnp.ndarray    # (..., 3)
    ba: jnp.ndarray    # (..., 3)


def retract(s: BodyState, dx: jnp.ndarray) -> BodyState:
    """Apply a 15-dim tangent [dphi, dp, dv, dbg, dba] (ImuCamPose::Update)."""
    R = _mm(s.R_wb, so3_exp(dx[..., 0:3]))
    p = s.p_w + _mv(s.R_wb, dx[..., 3:6])
    return BodyState(R, p, s.v_w + dx[..., 6:9], s.bg + dx[..., 9:12],
                     s.ba + dx[..., 12:15])


def body_to_cam(s: BodyState, R_bc: jnp.ndarray, t_bc: jnp.ndarray):
    """T_cw from a body state: X_c = R_cb (R_wb^T (X_w - p_w)) + t_cb."""
    R_cb = jnp.swapaxes(R_bc, -1, -2)
    t_cb = -_mv(R_cb, t_bc)
    R_cw = _mm(R_cb, jnp.swapaxes(s.R_wb, -1, -2))
    t_cw = t_cb - _mv(R_cw, s.p_w)
    return R_cw, t_cw


def cam_to_body(R_cw, t_cw, R_bc, t_bc):
    """Invert body_to_cam: body pose (R_wb, p_w) from a camera pose T_cw.

    With X_b = R_bc X_c + t_bc (T_bc: body <- camera, the reference's
    Calib.mTbc convention): R_wc = R_wb R_bc, so R_wb = R_wc R_bc^T and
    p_w = C_w - R_wb t_bc with camera center C_w = -R_wc t_cw."""
    R_wc = jnp.swapaxes(R_cw, -1, -2)
    R_wb = _mm(R_wc, jnp.swapaxes(R_bc, -1, -2))
    p_w = -_mv(R_wc, t_cw) - _mv(R_wb, t_bc)
    return R_wb, p_w


def inertial_residual(
    pre: Preintegrated, s1: BodyState, s2: BodyState, bias_state: BodyState
) -> jnp.ndarray:
    """EdgeInertial::computeError (G2oTypes.cc): 9-dim [er, ev, ep].

    Bias corrections are linearized at ``bias_state``'s biases (the
    reference attaches the FIRST state's bias vertices to the edge)."""
    b = ImuBias(bias_state.bg, bias_state.ba)
    dbg = b.bg - pre.b0.bg
    dba = b.ba - pre.b0.ba
    dR = _mm(pre.dR, so3_exp(_mv(pre.JRg, dbg)))
    dV = pre.dV + _mv(pre.JVg, dbg) + _mv(pre.JVa, dba)
    dP = pre.dP + _mv(pre.JPg, dbg) + _mv(pre.JPa, dba)
    dt = pre.dT
    g = jnp.asarray(GRAVITY, dtype=s1.p_w.dtype)
    R1T = jnp.swapaxes(s1.R_wb, -1, -2)
    er = so3_log(_mm(jnp.swapaxes(dR, -1, -2), _mm(R1T, s2.R_wb)))
    ev = _mv(R1T, s2.v_w - s1.v_w - g * dt) - dV
    ep = _mv(R1T, s2.p_w - s1.p_w - s1.v_w * dt - 0.5 * g * dt * dt) - dP
    return jnp.concatenate([er, ev, ep], axis=-1)


def _info_sqrt(C: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Upper-triangular square root W with W^T W = C^{-1} (whitening).

    Uses eigh for robustness (C is PSD but can be near-singular for very
    short preintegration intervals)."""
    w, V = jnp.linalg.eigh(C)
    w = jnp.maximum(w, eps)
    return (V * (1.0 / jnp.sqrt(w))) @ V.T  # symmetric inverse sqrt


def _sqrtm_psd(H: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Symmetric PSD square root W with W W = H (for whitening priors)."""
    w, V = jnp.linalg.eigh(H)
    w = jnp.maximum(w, eps)
    return (V * jnp.sqrt(w)) @ V.T


class VIPoseResult(NamedTuple):
    state: BodyState
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray
    # 15x15 information of the optimized state at the solution (visual +
    # inertial, inlier-weighted) — the ConstraintPoseImu prior carried to
    # the next frame's LastFrame-anchored solve (Optimizer.cc:4850-4870
    # builds mpcpi from the recovered hessian the same way).
    H: jnp.ndarray = None


@functools.partial(jax.jit, static_argnames=("rounds", "iters"))
def pose_inertial_optimize(
    cam: Camera,
    bf: jnp.ndarray,
    R_bc: jnp.ndarray,       # (3,3) body <- camera
    t_bc: jnp.ndarray,       # (3,)
    prev: BodyState,         # anchor state (last KF or last frame), FIXED
    pre: Preintegrated,      # preintegration prev -> current
    s0: BodyState,           # initial current state
    Xw: jnp.ndarray,         # (N, 3)
    obs_uv: jnp.ndarray,     # (N, 2)
    obs_ur: jnp.ndarray,     # (N,)  < 0 => mono edge
    inv_sigma2: jnp.ndarray, # (N,)
    valid: jnp.ndarray,      # (N,) bool
    prior_H: jnp.ndarray | None = None,  # (15,15) ConstraintPoseImu info
    rounds: int = 4,
    iters: int = 10,
) -> VIPoseResult:
    """Motion-only VI optimization (Optimizer.cc:4491/:4875 semantics).

    Unknowns: the current body state (15 dof). The previous state is fixed;
    its information enters through the inertial edge + bias priors (and the
    optional ``prior_H`` marginal prior, the LastFrame variant's
    ConstraintPoseImu)."""
    is_stereo = obs_ur >= 0
    dtype = Xw.dtype

    # Whitening for the inertial edge: C[:9,:9] over [phi, v, p].
    W_in = _info_sqrt(pre.C[:9, :9].astype(jnp.float64)).astype(dtype)
    # Bias random-walk priors (EdgePriorGyro/Acc info = C blocks inverse).
    W_bg = _info_sqrt(pre.C[9:12, 9:12].astype(jnp.float64)).astype(dtype)
    W_ba = _info_sqrt(pre.C[12:15, 12:15].astype(jnp.float64)).astype(dtype)

    def vis_residual(s: BodyState):
        R_cw, t_cw = body_to_cam(s, R_bc, t_bc)
        Xc = _mv(R_cw, Xw) + t_cw
        uv = project(cam, Xc)
        z = jnp.maximum(Xc[..., 2], 1e-6)
        ur = uv[..., 0] - bf / z
        du = obs_uv[..., 0] - uv[..., 0]
        dv = obs_uv[..., 1] - uv[..., 1]
        dur = jnp.where(is_stereo, obs_ur - ur, 0.0)
        return jnp.stack([du, dv, dur], axis=-1)  # (N, 3)

    def in_residual(s: BodyState):
        r9 = inertial_residual(pre, prev, s, s)  # bias vertices = current
        rbg = _mv(W_bg, s.bg - prev.bg)
        rba = _mv(W_ba, s.ba - prev.ba)
        return jnp.concatenate([_mv(W_in, r9), rbg, rba])  # (15,) whitened

    def chi2_fn(s):
        r = vis_residual(s)
        return jnp.sum(r * r, axis=-1) * inv_sigma2

    def gn_round(s, inlier_mask, use_robust, n_iters):
        delta2 = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)

        def cost(s, w):
            rv = vis_residual(s)
            c_vis = jnp.sum(jnp.sum(rv * rv, -1) * w)
            ri = in_residual(s)
            c = c_vis + jnp.sum(ri * ri)
            if prior_H is not None:
                dx0 = state_diff(s, s_lin)
                c = c + dx0 @ prior_H @ dx0
            return c

        def body(carry, _):
            s, lam = carry
            rv = vis_residual(s)
            chi2 = jnp.sum(rv * rv, axis=-1) * inv_sigma2
            w_rob = jnp.where(use_robust, huber_weight(chi2, delta2), 1.0)
            w = w_rob * inv_sigma2 * inlier_mask

            def res_of_dx(dx):
                sp = retract(s, dx)
                return vis_residual(sp), in_residual(sp)

            (Jv, Ji) = jax.jacfwd(res_of_dx)(jnp.zeros(15, dtype))
            rv_flat = rv  # (N,3)
            H = jnp.einsum("nij,nik,n->jk", Jv, Jv, w) + Ji.T @ Ji
            g = jnp.einsum("nij,ni,n->j", Jv, rv_flat, w) + Ji.T @ in_residual(s)
            if prior_H is not None:
                dx0 = state_diff(s, s_lin)
                H = H + prior_H
                g = g + prior_H @ dx0
            D = jnp.diag(jnp.diag(H))
            dx = jnp.linalg.solve(H + lam * D + 1e-9 * jnp.eye(15, dtype=dtype), -g)
            s_new = retract(s, dx)
            c_old = cost(s, w)
            c_new = cost(s_new, w)
            accept = c_new < c_old
            s = jax.tree_util.tree_map(
                lambda a, b: jnp.where(accept, a, b), s_new, s
            )
            lam = jnp.where(accept, lam * 0.5, lam * 4.0)
            return (s, lam), None

        (s, _), _ = jax.lax.scan(
            body, (s, jnp.asarray(1e-2, dtype)), None, length=n_iters
        )
        return s

    def state_diff(s, s_ref):
        """15-dim tangent from s_ref to s (for the marginal prior)."""
        dphi = so3_log(_mm(jnp.swapaxes(s_ref.R_wb, -1, -2), s.R_wb))
        dp = _mv(jnp.swapaxes(s_ref.R_wb, -1, -2), s.p_w - s_ref.p_w)
        return jnp.concatenate(
            [dphi, dp, s.v_w - s_ref.v_w, s.bg - s_ref.bg, s.ba - s_ref.ba]
        )

    s_lin = s0
    s = s0
    inlier = valid.astype(dtype)
    for rnd in range(rounds):
        use_robust = rnd < 2
        s = gn_round(s, inlier, use_robust, iters)
        chi2 = chi2_fn(s)
        thr = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
        inlier = (valid & (chi2 <= thr)).astype(dtype)

    inl = inlier > 0

    # Information of the solution for the next frame's ConstraintPoseImu.
    def res_of_dx_fin(dx):
        sp = retract(s, dx)
        return vis_residual(sp), in_residual(sp)

    Jv_f, Ji_f = jax.jacfwd(res_of_dx_fin)(jnp.zeros(15, dtype))
    w_fin = inlier * inv_sigma2
    H_fin = jnp.einsum("nij,nik,n->jk", Jv_f, Jv_f, w_fin) + Ji_f.T @ Ji_f
    return VIPoseResult(s, inl, jnp.sum(inl.astype(jnp.int32)), H_fin)


@functools.partial(jax.jit, static_argnames=("rounds", "iters"))
def pose_inertial_optimize_lastframe(
    cam: Camera,
    bf: jnp.ndarray,
    R_bc: jnp.ndarray,
    t_bc: jnp.ndarray,
    prev0: BodyState,        # last-frame anchor state (FREE, softly held)
    prior_H: jnp.ndarray,    # (15,15) ConstraintPoseImu information on prev
    pre: Preintegrated,      # frame-to-frame preintegration prev -> current
    s0: BodyState,           # initial current state
    Xw: jnp.ndarray,
    obs_uv: jnp.ndarray,
    obs_ur: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    valid: jnp.ndarray,
    rounds: int = 4,
    iters: int = 10,
) -> VIPoseResult:
    """PoseInertialOptimizationLastFrame (Optimizer.cc:4875): joint 30-dof
    solve over [last frame, current frame]. The last frame is FREE but held
    by the EdgePriorPoseImu soft prior (``prior_H``, the marginal information
    of its own optimization) instead of being clamped — anchor error relaxes
    through the inertial edge instead of propagating rigidly."""
    is_stereo = obs_ur >= 0
    dtype = Xw.dtype

    W_in = _info_sqrt(pre.C[:9, :9].astype(jnp.float64)).astype(dtype)
    W_bg = _info_sqrt(pre.C[9:12, 9:12].astype(jnp.float64)).astype(dtype)
    W_ba = _info_sqrt(pre.C[12:15, 12:15].astype(jnp.float64)).astype(dtype)
    W_prior = _sqrtm_psd(prior_H.astype(jnp.float64)).astype(dtype)

    def state_diff(s, s_ref):
        dphi = so3_log(_mm(jnp.swapaxes(s_ref.R_wb, -1, -2), s.R_wb))
        dp = _mv(jnp.swapaxes(s_ref.R_wb, -1, -2), s.p_w - s_ref.p_w)
        return jnp.concatenate(
            [dphi, dp, s.v_w - s_ref.v_w, s.bg - s_ref.bg, s.ba - s_ref.ba]
        )

    def vis_residual(sc: BodyState):
        R_cw, t_cw = body_to_cam(sc, R_bc, t_bc)
        Xc = _mv(R_cw, Xw) + t_cw
        uv = project(cam, Xc)
        z = jnp.maximum(Xc[..., 2], 1e-6)
        ur = uv[..., 0] - bf / z
        du = obs_uv[..., 0] - uv[..., 0]
        dv = obs_uv[..., 1] - uv[..., 1]
        dur = jnp.where(is_stereo, obs_ur - ur, 0.0)
        return jnp.stack([du, dv, dur], axis=-1)

    def other_residuals(sp: BodyState, sc: BodyState):
        """Whitened inertial edge + bias walk + anchor prior: (30,)."""
        r9 = inertial_residual(pre, sp, sc, sp)
        rbg = _mv(W_bg, sc.bg - sp.bg)
        rba = _mv(W_ba, sc.ba - sp.ba)
        rp = _mv(W_prior, state_diff(sp, prev0))
        return jnp.concatenate([_mv(W_in, r9), rbg, rba, rp])

    def states_of(dx):
        return retract(prev0, dx[:15]), retract(s0, dx[15:])

    def chi2_fn(dx):
        _, sc = states_of(dx)
        r = vis_residual(sc)
        return jnp.sum(r * r, axis=-1) * inv_sigma2

    def gn_round(dx, inlier_mask, use_robust, n_iters):
        delta2 = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)

        def cost(dx, w):
            sp, sc = states_of(dx)
            rv = vis_residual(sc)
            ro = other_residuals(sp, sc)
            return jnp.sum(jnp.sum(rv * rv, -1) * w) + jnp.sum(ro * ro)

        def body(carry, _):
            dx, lam = carry
            sp, sc = states_of(dx)
            rv = vis_residual(sc)
            chi2 = jnp.sum(rv * rv, axis=-1) * inv_sigma2
            w_rob = jnp.where(use_robust, huber_weight(chi2, delta2), 1.0)
            w = w_rob * inv_sigma2 * inlier_mask

            def res_of_d(d):
                sp2, sc2 = states_of(dx + d)
                return vis_residual(sc2), other_residuals(sp2, sc2)

            Jv, Jo = jax.jacfwd(res_of_d)(jnp.zeros(30, dtype))
            ro = other_residuals(sp, sc)
            H = jnp.einsum("nij,nik,n->jk", Jv, Jv, w) + Jo.T @ Jo
            g = jnp.einsum("nij,ni,n->j", Jv, rv, w) + Jo.T @ ro
            D = jnp.diag(jnp.diag(H))
            step = jnp.linalg.solve(
                H + lam * D + 1e-9 * jnp.eye(30, dtype=dtype), -g
            )
            dx_new = dx + step
            accept = cost(dx_new, w) < cost(dx, w)
            dx = jnp.where(accept, dx_new, dx)
            lam = jnp.where(accept, lam * 0.5, lam * 4.0)
            return (dx, lam), None

        (dx, _), _ = jax.lax.scan(
            body, (dx, jnp.asarray(1e-2, dtype)), None, length=n_iters
        )
        return dx

    dx = jnp.zeros(30, dtype)
    inlier = valid.astype(dtype)
    for rnd in range(rounds):
        use_robust = rnd < 2
        dx = gn_round(dx, inlier, use_robust, iters)
        chi2 = chi2_fn(dx)
        thr = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
        inlier = (valid & (chi2 <= thr)).astype(dtype)

    sp, sc = states_of(dx)
    inl = inlier > 0

    # Marginal information of the CURRENT state: Hcc - Hca Haa^-1 Hac.
    def res_of_d_fin(d):
        sp2, sc2 = states_of(dx + d)
        return vis_residual(sc2), other_residuals(sp2, sc2)

    Jv_f, Jo_f = jax.jacfwd(res_of_d_fin)(jnp.zeros(30, dtype))
    w_fin = inlier * inv_sigma2
    H30 = jnp.einsum("nij,nik,n->jk", Jv_f, Jv_f, w_fin) + Jo_f.T @ Jo_f
    Haa = H30[:15, :15] + 1e-6 * jnp.eye(15, dtype=dtype)
    Hca = H30[15:, :15]
    Hcc = H30[15:, 15:]
    H_marg = Hcc - Hca @ jnp.linalg.solve(Haa, Hca.T)
    return VIPoseResult(sc, inl, jnp.sum(inl.astype(jnp.int32)), H_marg)


@functools.partial(jax.jit, static_argnames=("rounds", "iters"))
def pose_inertial_optimize_packed(
    cam, bf, R_bc, t_bc, prev, pre_buf, s0, Xw, obs_uv, obs_ur,
    inv_sigma2, valid, rounds: int = 4, iters: int = 10,
):
    """pose_inertial_optimize with the preintegration delivered as ONE
    packed (298,) buffer (the tracker keeps the running preintegration on
    host; a NamedTuple argument would be 14 separate uploads)."""
    from fasttrack_tpu.imu.preintegration import unpack_preintegrated

    pre = unpack_preintegrated(pre_buf)
    return pose_inertial_optimize(
        cam, bf, R_bc, t_bc, prev, pre, s0, Xw, obs_uv, obs_ur,
        inv_sigma2, valid, rounds=rounds, iters=iters,
    )


@functools.partial(jax.jit, static_argnames=("rounds", "iters"))
def pose_inertial_optimize_lastframe_packed(
    cam, bf, R_bc, t_bc, prev0, prior_H, pre_buf, s0, Xw, obs_uv, obs_ur,
    inv_sigma2, valid, rounds: int = 4, iters: int = 10,
):
    from fasttrack_tpu.imu.preintegration import unpack_preintegrated

    pre = unpack_preintegrated(pre_buf)
    return pose_inertial_optimize_lastframe(
        cam, bf, R_bc, t_bc, prev0, prior_H, pre, s0, Xw, obs_uv, obs_ur,
        inv_sigma2, valid, rounds=rounds, iters=iters,
    )


# ---------------------------------------------------------------------------
# Local inertial BA (Optimizer::LocalInertialBA, Optimizer.cc:2383)
# ---------------------------------------------------------------------------


class InertialBAProblem(NamedTuple):
    """Temporal window of K keyframe states + L points, fixed shapes.

    states:     BodyState with leading dim K (state 0 = oldest; states with
                ``state_free[k]==False`` are the fixed frontier, e.g. the KF
                before the window).
    pre_*:      stacked Preintegrated between consecutive states
                (K-1 of them); ``pre_valid[k]`` masks gaps.
    Visual obs mirror optim.local_ba.BAProblem.
    """

    states: BodyState              # (K, ...)
    state_free: jnp.ndarray        # (K,) bool
    pre: Preintegrated             # stacked, leading dim K-1
    pre_valid: jnp.ndarray         # (K-1,) bool
    points: jnp.ndarray            # (L, 3)
    point_free: jnp.ndarray        # (L,) bool
    obs_uv: jnp.ndarray            # (L, K, 2)
    obs_ur: jnp.ndarray            # (L, K)
    inv_sigma2: jnp.ndarray        # (L, K)
    mask: jnp.ndarray              # (L, K) bool


class InertialBAResult(NamedTuple):
    states: BodyState
    points: jnp.ndarray
    inlier_mask: jnp.ndarray  # (L, K)


@functools.partial(jax.jit, static_argnames=("iters",))
def local_inertial_ba(
    prob: InertialBAProblem,
    cam: Camera,
    bf: jnp.ndarray,
    R_bc: jnp.ndarray,
    t_bc: jnp.ndarray,
    iters: int = 8,
) -> InertialBAResult:
    """Temporal-window VI bundle adjustment with Schur-eliminated points.

    Unknowns: K*15 state tangents + L*3 points. Each GN iteration:
    - visual residuals (L, K, 3) via vmapped projection (autodiff Jacobians)
    - inertial residuals (K-1, 15) whitened by the preintegration covariance
    - dense Schur complement over the point blocks (L tiny 3x3 inverses)
    - damped solve of the reduced (K*15) system.
    """
    K = prob.obs_uv.shape[1]
    L = prob.points.shape[0]
    dtype = prob.points.dtype
    is_stereo = prob.obs_ur >= 0

    # Whitening matrices per interval (15: [phi,v,p] 9 + bias walk 6).
    def whiten_blocks(C):
        W9 = _info_sqrt(C[:9, :9].astype(jnp.float64)).astype(dtype)
        Wbg = _info_sqrt(C[9:12, 9:12].astype(jnp.float64)).astype(dtype)
        Wba = _info_sqrt(C[12:15, 12:15].astype(jnp.float64)).astype(dtype)
        return W9, Wbg, Wba

    W9s, Wbgs, Wbas = jax.vmap(whiten_blocks)(prob.pre.C)

    def vis_res_one(state_k, pts):
        R_cw, t_cw = body_to_cam(state_k, R_bc, t_bc)
        Xc = _mv(R_cw, pts) + t_cw
        uv = project(cam, Xc)
        z = jnp.maximum(Xc[..., 2], 1e-6)
        ur = uv[..., 0] - bf / z
        return uv, ur

    def vis_residuals(states, pts):
        """(L, K, 3) residuals."""
        def per_kf(k):
            sk = jax.tree_util.tree_map(lambda x: x[k], states)
            uv, ur = vis_res_one(sk, pts)
            du = prob.obs_uv[:, k, 0] - uv[:, 0]
            dv = prob.obs_uv[:, k, 1] - uv[:, 1]
            dur = jnp.where(is_stereo[:, k], prob.obs_ur[:, k] - ur, 0.0)
            return jnp.stack([du, dv, dur], -1)

        return jnp.stack([per_kf(k) for k in range(K)], axis=1)

    def inertial_residuals(states):
        """(K-1, 15) whitened inertial + bias-walk residuals."""
        def per_edge(k):
            s1 = jax.tree_util.tree_map(lambda x: x[k], states)
            s2 = jax.tree_util.tree_map(lambda x: x[k + 1], states)
            pre_k = jax.tree_util.tree_map(lambda x: x[k], prob.pre)
            r9 = inertial_residual(pre_k, s1, s2, s1)
            rbg = _mv(Wbgs[k], s2.bg - s1.bg)
            rba = _mv(Wbas[k], s2.ba - s1.ba)
            r = jnp.concatenate([_mv(W9s[k], r9), rbg, rba])
            return jnp.where(prob.pre_valid[k], r, jnp.zeros_like(r))

        return jnp.stack([per_edge(k) for k in range(K - 1)])

    free_s = prob.state_free.astype(dtype)
    free_p = prob.point_free.astype(dtype)

    def step(carry, _):
        states, pts, lam = carry
        rv = vis_residuals(states, pts)                   # (L, K, 3)
        chi2 = jnp.sum(rv * rv, -1) * prob.inv_sigma2     # (L, K)
        delta2 = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
        w_rob = huber_weight(chi2, delta2)
        w = w_rob * prob.inv_sigma2 * prob.mask           # (L, K)

        # Jacobians of the visual residual wrt state tangent and point.
        def res_lk(dx_k, dX_l, k_state, pt, obs_uv, obs_ur, st):
            sk = retract(k_state, dx_k)
            R_cw, t_cw = body_to_cam(sk, R_bc, t_bc)
            Xc = _mv(R_cw, pt + dX_l) + t_cw
            uv = project(cam, Xc)
            z = jnp.maximum(Xc[2], 1e-6)
            ur = uv[0] - bf / z
            du = obs_uv[0] - uv[0]
            dv = obs_uv[1] - uv[1]
            dur = jnp.where(st, obs_ur - ur, 0.0)
            return jnp.stack([du, dv, dur])

        zeros15 = jnp.zeros(15, dtype)
        zeros3 = jnp.zeros(3, dtype)

        def jac_for_k(k):
            sk = jax.tree_util.tree_map(lambda x: x[k], states)
            Js, Jp = jax.vmap(
                lambda pt, ouv, our, st: jax.jacfwd(res_lk, argnums=(0, 1))(
                    zeros15, zeros3, sk, pt, ouv, our, st
                )
            )(pts, prob.obs_uv[:, k], prob.obs_ur[:, k], is_stereo[:, k])
            return Js, Jp  # (L,3,15), (L,3,3)

        Js_all, Jp_all = [], []
        for k in range(K):
            Js, Jp = jac_for_k(k)
            Js_all.append(Js)
            Jp_all.append(Jp)
        Js = jnp.stack(Js_all, 1)  # (L, K, 3, 15)
        Jp = jnp.stack(Jp_all, 1)  # (L, K, 3, 3)

        # Inertial part: Jacobian wrt all state tangents.
        def in_res_of_dx(dxs):
            sts = jax.vmap(retract)(states, dxs * free_s[:, None])
            return inertial_residuals(sts)

        ri = inertial_residuals(states)                       # (K-1, 15)
        Ji = jax.jacfwd(in_res_of_dx)(jnp.zeros((K, 15), dtype))  # (K-1,15,K,15)

        # Assemble normal equations.
        # Visual blocks:
        Hss_v = jnp.einsum("lkim,lkin,lk->kmn", Js, Js, w)    # (K,15,15) diag blocks
        Hsp = jnp.einsum("lkim,lkin,lk->lkmn", Js, Jp, w)     # (L,K,15,3)
        Hpp = jnp.einsum("lkim,lkin,lk->lmn", Jp, Jp, w)      # (L,3,3)
        gs_v = jnp.einsum("lkim,lki,lk->km", Js, rv, w)       # (K,15)
        gp = jnp.einsum("lkim,lki,lk->lm", Jp, rv, w)         # (L,3)

        # Inertial blocks (dense over states).
        Ji2 = Ji.reshape(-1, K * 15)                          # (E*15, K*15)
        H_in = Ji2.T @ Ji2                                    # (K*15, K*15)
        g_in = Ji2.T @ ri.reshape(-1)

        H = H_in.reshape(K, 15, K, 15)
        H = H.at[jnp.arange(K), :, jnp.arange(K), :].add(Hss_v)
        g = g_in.reshape(K, 15) + gs_v

        # Schur: eliminate points. Hpp' = Hpp + lam*diag + eps
        Hpp_d = Hpp + (lam * jax.vmap(jnp.diag)(jax.vmap(jnp.diag)(Hpp))
                       + 1e-6 * jnp.eye(3, dtype=dtype))
        Hpp_inv = jnp.linalg.inv(Hpp_d) * free_p[:, None, None]
        # S -= sum_l Hsp_l Hpp_inv_l Hsp_l^T  (block (K,15)x(K,15))
        T1 = jnp.einsum("lkmi,lij->lkmj", Hsp, Hpp_inv)       # (L,K,15,3)
        S_red = jnp.einsum("lkmj,lqnj->kmqn", T1, Hsp)        # (K,15,K,15)
        S = H - S_red
        rhs = g - jnp.einsum("lkmj,lj->km", T1, gp)

        # Fix non-free states: zero their rows/cols, unit diagonal.
        mfree = jnp.repeat(free_s, 15)
        S2 = S.reshape(K * 15, K * 15)
        S2 = S2 * mfree[:, None] * mfree[None, :] + jnp.diag(1.0 - mfree)
        rhs2 = rhs.reshape(-1) * mfree
        D = jnp.diag(jnp.diag(S2))
        dx_s = jnp.linalg.solve(S2 + lam * D + 1e-6 * jnp.eye(K * 15, dtype=dtype),
                                -rhs2).reshape(K, 15)
        # Back-substitute points: dp = -Hpp_inv (gp + Hsp^T dx_s)
        gp_corr = gp + jnp.einsum("lkmi,km->li", Hsp, dx_s)
        dp = -_mv(Hpp_inv, gp_corr)

        states_new = jax.vmap(retract)(states, dx_s * free_s[:, None])
        pts_new = pts + dp * free_p[:, None]

        def total_cost(sts, ps):
            r = vis_residuals(sts, ps)
            c = jnp.sum(jnp.sum(r * r, -1) * w)
            ri_ = inertial_residuals(sts)
            return c + jnp.sum(ri_ * ri_)

        c_old = total_cost(states, pts)
        c_new = total_cost(states_new, pts_new)
        accept = c_new < c_old
        states = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), states_new, states
        )
        pts = jnp.where(accept, pts_new, pts)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        return (states, pts, lam), None

    (states, pts, _), _ = jax.lax.scan(
        step, (prob.states, prob.points, jnp.asarray(1e-3, dtype)), None,
        length=iters,
    )
    rv = vis_residuals(states, pts)
    chi2 = jnp.sum(rv * rv, -1) * prob.inv_sigma2
    thr = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    inl = prob.mask & (chi2 <= thr)
    return InertialBAResult(states, pts, inl)
