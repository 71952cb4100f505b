"""Shared bundle-adjustment window assembly + writeback over the host map.

One packing/writeback path consumed by LocalMapper._local_ba, the loop
closer's global BA sweeps, and parallel.dist_ba — the fixed-shape BAProblem
(optim.local_ba) is the single solver unit everywhere (VERDICT r2 #8: one
assembly, no duplicated math).

Parity: the g2o problem construction in Optimizer::LocalBundleAdjustment
(src/Optimizer.cc:1116) / GlobalBundleAdjustemnt (src/Optimizer.cc:52-60):
free keyframes, fixed frontier keyframes, their map points, per-observation
information from the keypoint's pyramid level.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from fasttrack_tpu.geometry import SE3
from fasttrack_tpu.nputils import orthonormalize
from fasttrack_tpu.optim import BAProblem, local_bundle_adjustment


class WindowMeta(NamedTuple):
    kf_index: dict          # kid -> column j
    mp_ids: list            # row li -> map point id
    cam_free: np.ndarray    # (K,) bool
    mask: np.ndarray        # (L, K) bool as packed


def assemble_window(
    m,
    local_ids: list,
    fixed_ids: list,
    inv_sigma2: np.ndarray,
    max_kfs: int,
    max_points: int,
    mp_ids: list | None = None,
):
    """Pack a covisibility window into a fixed-shape BAProblem.

    local_ids: free keyframes; fixed_ids: frontier (poses held constant).
    mp_ids: optional explicit point set; default = all points observed by
    the free keyframes (capped at max_points, overflow counted)."""
    local_set = set(local_ids)
    all_kf_ids = (list(local_ids) + list(fixed_ids))[:max_kfs]
    K = max_kfs
    L = max_points

    if mp_ids is None:
        mp_ids = []
        seen = set()
        for kid in local_ids:
            kf = m.keyframes.get(kid)
            if kf is None:
                continue
            for mid in kf.mp_ids:
                if mid >= 0 and int(mid) not in seen:
                    mp = m.mappoints.get(int(mid))
                    if mp is not None and not mp.bad:
                        seen.add(int(mid))
                        mp_ids.append(int(mid))
    n_dropped = max(0, len(mp_ids) - L)
    mp_ids = mp_ids[:L]

    kf_index = {kid: j for j, kid in enumerate(all_kf_ids)}
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = np.zeros((K, 3), np.float32)
    cam_free = np.zeros(K, bool)
    for kid, j in kf_index.items():
        kf = m.keyframes[kid]
        R[j] = kf.R_cw
        t[j] = kf.t_cw
        cam_free[j] = kid in local_set
    # Gauge: with no fixed frontier, pin the oldest keyframe.
    if cam_free[: len(all_kf_ids)].all() and len(all_kf_ids) > 1:
        cam_free[kf_index[min(all_kf_ids)]] = False

    pts = np.zeros((L, 3), np.float32)
    pt_free = np.zeros(L, bool)
    obs_uv = np.zeros((L, K, 2), np.float32)
    obs_ur = np.full((L, K), -1.0, np.float32)
    inv_s2 = np.ones((L, K), np.float32)
    mask = np.zeros((L, K), bool)
    for li, mid in enumerate(mp_ids):
        mp = m.mappoints.get(mid)
        if mp is None or mp.bad:
            continue
        pts[li] = mp.position
        pt_free[li] = True
        for kid, fi in mp.observations.items():
            j = kf_index.get(kid)
            if j is None:
                continue
            kf = m.keyframes[kid]
            if fi >= len(kf.kp_uv) or not kf.valid[fi]:
                continue
            obs_uv[li, j] = kf.kp_uv[fi]
            obs_ur[li, j] = kf.u_right[fi]
            inv_s2[li, j] = inv_sigma2[kf.kp_level[fi]]
            mask[li, j] = True

    prob = BAProblem(
        poses=SE3(jnp.asarray(R), jnp.asarray(t)),
        points=jnp.asarray(pts),
        obs_uv=jnp.asarray(obs_uv),
        obs_ur=jnp.asarray(obs_ur),
        inv_sigma2=jnp.asarray(inv_s2),
        mask=jnp.asarray(mask),
        cam_free=jnp.asarray(cam_free),
        point_free=jnp.asarray(pt_free),
    )
    meta = WindowMeta(kf_index, mp_ids, cam_free, mask)
    return prob, meta, n_dropped


def write_back(m, meta: WindowMeta, res, drop_outliers: bool = True):
    """Apply solved poses/points to the map; detach chi2-outlier
    observations (Optimizer.cc LocalBA post-pass). NaN-guarded: a diverged
    block never corrupts the map."""
    R_new = np.asarray(res.poses.R, np.float64)
    t_new = np.asarray(res.poses.t, np.float64)
    pts_new = np.asarray(res.points, np.float64)
    inl = np.asarray(res.inlier_mask)
    for kid, j in meta.kf_index.items():
        if meta.cam_free[j] and np.isfinite(R_new[j]).all() and np.isfinite(t_new[j]).all():
            kf = m.keyframes.get(kid)
            if kf is not None:
                kf.set_pose(orthonormalize(R_new[j]), t_new[j])
    for li, mid in enumerate(meta.mp_ids):
        mp = m.mappoints.get(mid)
        if mp is None:
            continue
        if np.isfinite(pts_new[li]).all():
            mp.position = pts_new[li]
        if not drop_outliers:
            continue
        for kid, fi in list(mp.observations.items()):
            j = meta.kf_index.get(kid)
            if j is None or not meta.mask[li, j]:
                continue
            if not inl[li, j]:
                kf = m.keyframes.get(kid)
                if kf is not None and kf.mp_ids[fi] == mid:
                    kf.mp_ids[fi] = -1
                if mp.erase_observation(kid):
                    m.erase_mappoint(mid)
                    break
    m.info_changed()


def solve_window(
    m, local_ids, fixed_ids, camera, bf, inv_sigma2,
    max_kfs: int, max_points: int, mp_ids=None, drop_outliers=True,
):
    """assemble -> solve -> write back. Returns (n_dropped_points)."""
    prob, meta, n_dropped = assemble_window(
        m, local_ids, fixed_ids, inv_sigma2, max_kfs, max_points, mp_ids
    )
    res = local_bundle_adjustment(prob, camera, jnp.float32(bf))
    write_back(m, meta, res, drop_outliers)
    return n_dropped


def global_bundle_adjustment(
    m, camera, bf, inv_sigma2,
    max_kfs: int = 16, max_points: int = 2048,
    n_sweeps: int = 2, fixed_kf_ids: set | None = None,
    should_abort=None, lock=None,
):
    """Whole-map BA (Optimizer::GlobalBundleAdjustemnt, Optimizer.cc:52;
    driven from RunGlobalBundleAdjustment, LoopClosing.cc:2268-2512).

    Fixed-shape design: instead of one huge sparse g2o solve (dynamic
    sparsity = recompilation), the map is swept in fixed-shape Schur windows
    (the XLA-compiled unit) in keyframe-id order with a half-window overlap;
    each block's frontier (neighbouring keyframes outside the block) is held
    fixed, and `n_sweeps` passes propagate corrections across blocks.
    `should_abort` is polled between blocks — the reference's mbStopGBA
    interruption protocol. With `lock=None` the caller holds the map lock
    for the whole run (synchronous mode); with a lock given, each BLOCK
    acquires it briefly — the async-GBA protocol (the reference runs GBA on
    a spawned thread and merges back under mMutexMapUpdate,
    LoopClosing.cc:2268-2512) so tracking/mapping interleave between
    blocks."""
    import contextlib

    hold = (lambda: lock) if lock is not None else (
        lambda: contextlib.nullcontext()
    )
    with hold():
        kf_ids = sorted(m.keyframes)
    if len(kf_ids) < 3:
        return 0
    fixed_always = set(fixed_kf_ids or ()) | {m.init_kf_id}
    block = max(4, max_kfs - 4)
    n_blocks = 0
    for sweep in range(n_sweeps):
        start = 0 if sweep % 2 == 0 else block // 2  # offset alternate sweeps
        i = start
        while i < len(kf_ids):
            if should_abort is not None and should_abort():
                return n_blocks
            with hold():
                local = [
                    k for k in kf_ids[i:i + block]
                    if k not in fixed_always and k in m.keyframes
                ]
                if local:
                    local_set = set(local)
                    # frontier: keyframes observing the block's points
                    frontier = []
                    seen_pts = set()
                    for kid in local:
                        for mid in m.keyframes[kid].mp_ids:
                            if mid >= 0 and int(mid) not in seen_pts:
                                seen_pts.add(int(mid))
                                mp = m.mappoints.get(int(mid))
                                if mp is None:
                                    continue
                                for okid in mp.observations:
                                    if (
                                        okid not in local_set
                                        and okid in m.keyframes
                                        and okid not in frontier
                                    ):
                                        frontier.append(okid)
                        if len(local) + len(frontier) >= max_kfs:
                            break
                    solve_window(
                        m, local, frontier[: max_kfs - len(local)], camera, bf,
                        inv_sigma2, max_kfs, max_points, drop_outliers=False,
                    )
                    n_blocks += 1
            i += block
    return n_blocks
