"""Distributed bundle adjustment + sharded frame extraction over a Mesh.

The multi-device scaling design (SURVEY.md section 2.4): landmarks shard
across devices along the flat 1-D mesh axis "map"; each device builds the
Schur contributions of its landmark shard and the reduced camera system is
formed with one psum; the (small, dense) 6K x 6K solve is replicated, point
back-substitution stays local to each shard. Frame batches shard across the
same axis for parallel ORB extraction ("frame" parallelism — the
multi-stream analog).

XLA inserts the collectives from the shard_map specs; on GPUs it hands them
to NCCL, which runs them over NVLink between the cards of one host.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from fasttrack_tpu.cameras.models import Camera
from fasttrack_tpu.geometry import SE3
from fasttrack_tpu.optim import ba_core
from fasttrack_tpu.optim.local_ba import BAProblem


def make_mesh(n_devices: int | None = None, axis: str = "map") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _ba_shard_step(
    cam: Camera, bf, lam, axis: str,
    poses_R, poses_t, points, obs_uv, obs_ur, inv_sigma2, mask, cam_free, point_free,
):
    """One damped GN iteration; runs on each device over its landmark shard.

    IDENTICAL math to the single-device window solver — both consume
    optim.ba_core; the only distributed addition is the psum of the reduced
    camera-system contributions over the mesh axis."""
    poses = SE3(poses_R, poses_t)
    r, behind = ba_core.residuals(poses, points, cam, bf, obs_uv, obs_ur)
    live = mask * (~behind) * jnp.isfinite(r).all(axis=-1)
    r = jnp.where(live[..., None] > 0, r, 0.0)
    _, w = ba_core.robust_weights(r, live, inv_sigma2, obs_ur, True)
    Jc, Jp = ba_core.jacobians(poses, points, cam, bf, obs_uv, obs_ur)
    Jc = jnp.where(live[..., None, None] > 0, Jc, 0.0)
    Jp = jnp.where(live[..., None, None] > 0, Jp, 0.0)
    Jc = jnp.where(jnp.isfinite(Jc), Jc, 0.0)
    Jp = jnp.where(jnp.isfinite(Jp), Jp, 0.0)

    S_off, rhs, Hcc, Hpp_inv, Hcp, bp = ba_core.schur_camera_contrib(
        Jc, Jp, r, w, lam, points.dtype
    )
    # all-reduce: every device gets the full reduced camera system.
    S_off = jax.lax.psum(S_off, axis)
    rhs = jax.lax.psum(rhs, axis)
    Hcc = jax.lax.psum(Hcc, axis)
    dxc = ba_core.assemble_and_solve(S_off, rhs, Hcc, lam, cam_free, points.dtype)
    dxp = ba_core.backsub_points(Hpp_inv, Hcp, bp, dxc, point_free)

    poses_new = ba_core.apply_pose_update(poses, dxc)
    return poses_new.R, poses_new.t, points + dxp


def _ba_shard_cost(
    cam: Camera, bf, axis: str,
    poses_R, poses_t, points, obs_uv, obs_ur, inv_sigma2, mask,
):
    """Total robust chi2 over all shards (psum-reduced scalar).

    Observations that die (point behind camera / non-finite residual) cost a
    LARGE constant instead of zero — otherwise the LM accept/reject prefers
    degenerate states that throw every point behind the camera (cost
    silently collapses to 0; observed)."""
    poses = SE3(poses_R, poses_t)
    r, behind = ba_core.residuals(poses, points, cam, bf, obs_uv, obs_ur)
    alive = (~behind) * jnp.isfinite(r).all(axis=-1)
    live = mask * alive
    r = jnp.where(live[..., None] > 0, r, 0.0)
    chi2, _ = ba_core.robust_weights(r, live, inv_sigma2, obs_ur, True)
    dead_pen = jnp.sum(mask * (1.0 - alive)) * 1e4
    return jax.lax.psum(jnp.sum(chi2) + dead_pen, axis)


@functools.lru_cache(maxsize=None)
def _build_ba_fn(mesh: Mesh, axis: str, cam_static: tuple):
    """Cache the jitted shard_map program per (mesh, axis, camera kind) so
    repeated BA iterations hit the XLA executable cache instead of
    re-tracing (shapes are handled by jit's own cache)."""
    kind, width, height = cam_static
    shard = P(axis)
    rep = P()

    def fn(cam_params, bf, lam, poses_R, poses_t, points, obs_uv, obs_ur,
           inv_sigma2, mask, cam_free, point_free):
        cam = Camera(kind, cam_params, width, height)
        return _ba_shard_step(
            cam, bf, lam, axis,
            poses_R, poses_t, points, obs_uv, obs_ur, inv_sigma2, mask,
            cam_free, point_free,
        )

    mapped = shard_map(
        fn,
        mesh=mesh,
        in_specs=(rep, rep, rep, rep, rep, shard, shard, shard, shard, shard,
                  rep, shard),
        out_specs=(rep, rep, shard),
        check_vma=False,
    )
    return jax.jit(mapped)


def distributed_ba_iteration(
    problem: BAProblem, cam: Camera, bf, mesh: Mesh, lam: float = 1e-4,
    axis: str = "map",
):
    """One damped GN iteration of the BA window, landmarks sharded over
    `axis`. Returns (poses, points) with the same (global) shapes."""
    lamv = jnp.asarray(lam, problem.points.dtype)
    mapped = _build_ba_fn(mesh, axis, (cam.kind, cam.width, cam.height))
    R, t, pts = mapped(
        cam.params, jnp.asarray(bf, problem.points.dtype), lamv,
        problem.poses.R, problem.poses.t, problem.points,
        problem.obs_uv, problem.obs_ur, problem.inv_sigma2,
        problem.mask, problem.cam_free, problem.point_free,
    )
    return SE3(R, t), pts


def _ba_shard_chi2(
    cam: Camera, bf,
    poses_R, poses_t, points, obs_uv, obs_ur, inv_sigma2, mask,
):
    """Per-observation chi2 + inlier classification for one landmark shard
    (the single-device solver's final pass, local_ba.py:147-150). Purely
    shard-local: no collective — each device classifies its own landmarks."""
    from fasttrack_tpu.optim.robust import CHI2_MONO, CHI2_STEREO

    poses = SE3(poses_R, poses_t)
    r, behind = ba_core.residuals(poses, points, cam, bf, obs_uv, obs_ur)
    r = jnp.where(jnp.isfinite(r), r, 1e6)
    chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2
    delta2 = jnp.where(obs_ur >= 0, CHI2_STEREO, CHI2_MONO)
    inlier = (mask > 0) & (chi2 <= delta2) & (~behind)
    return inlier, chi2


@functools.lru_cache(maxsize=None)
def _build_chi2_fn(mesh: Mesh, axis: str, cam_static: tuple):
    kind, width, height = cam_static
    shard = P(axis)
    rep = P()

    def fn(cam_params, bf, poses_R, poses_t, points, obs_uv, obs_ur,
           inv_sigma2, mask):
        cam = Camera(kind, cam_params, width, height)
        return _ba_shard_chi2(
            cam, bf, poses_R, poses_t, points, obs_uv, obs_ur,
            inv_sigma2, mask,
        )

    mapped = shard_map(
        fn,
        mesh=mesh,
        in_specs=(rep, rep, rep, rep, shard, shard, shard, shard, shard),
        out_specs=(shard, shard),
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=None)
def _build_cost_fn(mesh: Mesh, axis: str, cam_static: tuple):
    kind, width, height = cam_static
    shard = P(axis)
    rep = P()

    def fn(cam_params, bf, poses_R, poses_t, points, obs_uv, obs_ur,
           inv_sigma2, mask):
        cam = Camera(kind, cam_params, width, height)
        return _ba_shard_cost(
            cam, bf, axis, poses_R, poses_t, points, obs_uv, obs_ur,
            inv_sigma2, mask,
        )

    mapped = shard_map(
        fn,
        mesh=mesh,
        in_specs=(rep, rep, rep, rep, shard, shard, shard, shard, shard),
        out_specs=rep,
        check_vma=False,
    )
    return jax.jit(mapped)


def distributed_bundle_adjustment(
    problem: BAProblem, cam: Camera, bf, mesh: Mesh,
    iters: int = 10, lam0: float = 1e-4, axis: str = "map",
):
    """Landmark-sharded LM to convergence: damped GN steps with host-side
    accept/reject (the reference's g2o LM schedule, Optimizer.cc:1116; here
    each iteration is one shard_map program + one psum'd cost program).

    Returns (poses, points, costs, inlier_mask, chi2) — costs per accepted
    state (monotone non-increasing after the first entry) plus the final
    chi2 outlier classification, matching the single-device solver's
    BAResult so the mapper culls identically through either path."""
    dt = problem.points.dtype
    bfv = jnp.asarray(bf, dt)
    cam_static = (cam.kind, cam.width, cam.height)
    step = _build_ba_fn(mesh, axis, cam_static)
    cost_fn = _build_cost_fn(mesh, axis, cam_static)

    def cost(poses, points):
        return float(cost_fn(
            cam.params, bfv, poses.R, poses.t, points,
            problem.obs_uv, problem.obs_ur, problem.inv_sigma2,
            problem.mask.astype(dt),
        ))

    poses, points = problem.poses, problem.points
    lam = lam0
    c = cost(poses, points)
    costs = [c]
    for _ in range(iters):
        R, t, pts = step(
            cam.params, bfv, jnp.asarray(lam, dt),
            poses.R, poses.t, points,
            problem.obs_uv, problem.obs_ur, problem.inv_sigma2,
            problem.mask.astype(dt), problem.cam_free, problem.point_free,
        )
        cand_poses, cand_points = SE3(R, t), pts
        c_new = cost(cand_poses, cand_points)
        if np.isfinite(c_new) and c_new < c:
            poses, points, c = cand_poses, cand_points, c_new
            lam = max(lam * 0.5, 1e-8)
            costs.append(c)
        else:
            lam = lam * 4.0
    chi2_fn = _build_chi2_fn(mesh, axis, cam_static)
    inlier, chi2 = chi2_fn(
        cam.params, bfv, poses.R, poses.t, points,
        problem.obs_uv, problem.obs_ur, problem.inv_sigma2,
        problem.mask.astype(dt),
    )
    return poses, points, costs, inlier, chi2


def sharded_extract_batch(images: jnp.ndarray, config, mesh: Mesh, axis: str = "map"):
    """Extract ORB features for a batch of frames, frames sharded over the
    mesh (per-host tracking streams feeding a shared map)."""
    from fasttrack_tpu.ops.extractor import extract_orb

    sharding = NamedSharding(mesh, P(axis))
    images = jax.device_put(images, sharding)

    @jax.jit
    def run(imgs):
        kps, _ = jax.vmap(lambda im: extract_orb(im, config))(imgs)
        return kps

    return run(images)
