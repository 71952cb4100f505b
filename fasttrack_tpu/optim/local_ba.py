"""Local bundle adjustment: masked LM with Schur-complement reduction.

Parity target: Optimizer::LocalBundleAdjustment (src/Optimizer.cc:1116):
covisibility-window keyframes (free) + frontier keyframes (fixed) + their
map points; 5 LM iterations, chi2 outlier removal (5.991 mono / 7.815
stereo), 10 more iterations; g2o block solver with landmark marginalization.

Design: the BA window is a dense fixed-shape problem —
(L points) x (K cameras) observation grid with a validity mask. Jacobians
come from one vmapped autodiff over observation pairs; the landmark blocks
are eliminated in closed form (3x3 inverses, batched) and the reduced camera
system (6K x 6K, K <= ~40) is a single dense solve. All of it is one jitted
program; 'removing' an edge = zeroing its mask entry, so no graph surgery
and no recompilation ever happens.

The same routine covers GlobalBundleAdjustment (Optimizer.cc:60) — a global
BA is just a BA window containing every keyframe (possibly solved in blocks).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from fasttrack_tpu.cameras.models import Camera, project
from fasttrack_tpu.geometry import SE3, se3_apply, se3_compose, se3_exp
from fasttrack_tpu.optim import ba_core
from fasttrack_tpu.optim.robust import CHI2_MONO, CHI2_STEREO, huber_weight


class BAProblem(NamedTuple):
    """Fixed-shape local BA window.

    K cameras (first `n_free` free, rest fixed), L landmarks,
    dense (L, K) observation grid with mask.
    """

    poses: SE3                 # batched (K,): Tcw
    points: jnp.ndarray        # (L, 3)
    obs_uv: jnp.ndarray        # (L, K, 2)
    obs_ur: jnp.ndarray        # (L, K) right-u; <0 => mono
    inv_sigma2: jnp.ndarray    # (L, K)
    mask: jnp.ndarray          # (L, K) bool
    cam_free: jnp.ndarray      # (K,) bool — False for frontier keyframes
    point_free: jnp.ndarray    # (L,) bool


class BAResult(NamedTuple):
    poses: SE3
    points: jnp.ndarray
    inlier_mask: jnp.ndarray   # (L, K) bool — post-chi2 classification
    chi2: jnp.ndarray          # (L, K)


def _residuals(poses: SE3, points, cam: Camera, bf, obs_uv, obs_ur):
    """(L, K, 3) residuals [du, dv, dur] (shared math: optim.ba_core)."""
    return ba_core.residuals(poses, points, cam, bf, obs_uv, obs_ur)


@functools.partial(jax.jit, static_argnames=("phase1_iters", "phase2_iters"))
def local_bundle_adjustment(
    problem: BAProblem,
    cam: Camera,
    bf: jnp.ndarray,
    phase1_iters: int = 5,
    phase2_iters: int = 10,
) -> BAResult:
    L, K = problem.mask.shape
    is_stereo = problem.obs_ur >= 0
    delta2 = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)

    def jacobians(poses, points):
        return ba_core.jacobians(
            poses, points, cam, bf, problem.obs_uv, problem.obs_ur
        )

    def weights(r, inlier, use_robust):
        chi2 = jnp.sum(r * r, axis=-1) * problem.inv_sigma2
        # Masked/degenerate entries can be inf/NaN; select them out (0 * inf
        # would be NaN, so jnp.where, not multiplication).
        chi2 = jnp.where(inlier > 0, chi2, 0.0)
        w_rob = jnp.where(use_robust, huber_weight(chi2, delta2), 1.0)
        return chi2, w_rob * problem.inv_sigma2 * inlier

    def lm_iter(poses, points, inlier, lam, use_robust):
        r, behind = _residuals(poses, points, cam, bf, problem.obs_uv, problem.obs_ur)
        # Residuals can overflow to inf in float32 for exploded points; such
        # observations must be fully dead or inf*0 -> NaN poisons the einsums.
        live = inlier * (~behind) * jnp.isfinite(r).all(axis=-1)
        r = jnp.where(live[..., None] > 0, r, 0.0)
        chi2, w = weights(r, live, use_robust)
        Jc, Jp = jacobians(poses, points)
        # Dead observations may have inf/NaN Jacobians (points at a camera
        # center in padded slots); zero them by selection before the einsums.
        Jc = jnp.where(live[..., None, None] > 0, Jc, 0.0)
        Jp = jnp.where(live[..., None, None] > 0, Jp, 0.0)
        Jc = jnp.where(jnp.isfinite(Jc), Jc, 0.0)
        Jp = jnp.where(jnp.isfinite(Jp), Jp, 0.0)

        # Shared Schur machinery (optim.ba_core): single-device = the
        # distributed solver with a no-op landmark reduction.
        S_off, rhs, Hcc, Hpp_inv, Hcp, bp = ba_core.schur_camera_contrib(
            Jc, Jp, r, w, lam, points.dtype
        )
        dxc = ba_core.assemble_and_solve(
            S_off, rhs, Hcc, lam, problem.cam_free, points.dtype
        )
        dxp = ba_core.backsub_points(Hpp_inv, Hcp, bp, dxc, problem.point_free)

        poses_new = ba_core.apply_pose_update(poses, dxc)
        points_new = points + dxp

        # Accept/reject.
        r_new, behind_new = _residuals(
            poses_new, points_new, cam, bf, problem.obs_uv, problem.obs_ur
        )
        chi2_new, w_new = weights(r_new, inlier * (~behind_new), use_robust)
        c_old = jnp.sum(chi2 * (w > 0))
        c_new = jnp.sum(chi2_new * (w_new > 0))
        step_ok = jnp.isfinite(dxc).all() & jnp.isfinite(dxp).all()
        accept = (c_new < c_old) & step_ok
        poses = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), poses_new, poses
        )
        points = jnp.where(accept, points_new, points)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        return poses, points, lam

    poses, points = problem.poses, problem.points
    inlier = problem.mask.astype(points.dtype)
    lam = jnp.asarray(1e-4, points.dtype)

    for _ in range(phase1_iters):
        poses, points, lam = lm_iter(poses, points, inlier, lam, use_robust=True)

    # chi2 outlier rejection between phases (Optimizer.cc LocalBA mid-check).
    r, behind = _residuals(poses, points, cam, bf, problem.obs_uv, problem.obs_ur)
    chi2 = jnp.sum(r * r, axis=-1) * problem.inv_sigma2
    inlier = (problem.mask & (chi2 <= delta2) & (~behind)).astype(points.dtype)

    for _ in range(phase2_iters):
        poses, points, lam = lm_iter(poses, points, inlier, lam, use_robust=False)

    r, behind = _residuals(poses, points, cam, bf, problem.obs_uv, problem.obs_ur)
    chi2 = jnp.sum(r * r, axis=-1) * problem.inv_sigma2
    final_inlier = problem.mask & (chi2 <= delta2) & (~behind)
    return BAResult(poses, points, final_inlier, chi2)
