"""Single-sync tracking: the whole OK-state frame as device programs with
ONE batched device->host fetch.

The stepwise tracker (tracking.py) costs ~5 blocking fetches per frame
(snapshot, TWM match, TWM pose, TLM match, TLM pose). Every input those
stages need from the host is derivable from the LAST frame's state plus the
motion prediction — so the host packs all query blocks up front, dispatches
the program chain asynchronously, and fetches every output in one batched
transfer (nputils.device_fetch): each sync serializes host and device.

Program split follows frame_pipeline's rules (extract / stereo /
match+opt as separate programs — XLA fusion across those boundaries is
pathological); "fused" here means fused CONTROL FLOW (no host syncs), not
one XLA program.

Parity anchors: Tracking::TrackWithMotionModel (Tracking.cc:2911) +
TrackLocalMap (:3042) with the per-frame stats design of Stats.cc:29 /
Tracking.cc:3143-3153. The one semantic delta vs the reference: the
local-map candidate SET comes from the previous frame's covisibility pass
(one-frame lag; positions are packed fresh each frame), because the set
selection is host work that must happen before the fetch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from fasttrack_tpu.cameras.models import Camera, project
from fasttrack_tpu.geometry import SE3
from fasttrack_tpu.ops.extractor import Keypoints, OrbConfig
from fasttrack_tpu.ops.project_match import (
    resolve_duplicates,
    rotation_consistency,
    search_by_projection,
    tlm_match,
)
from fasttrack_tpu.optim.pose_opt import pose_optimize


class TwmStepOut(NamedTuple):
    idx: jnp.ndarray        # (M,) matched keypoint per query
    keep: jnp.ndarray       # (M,) bool
    pose_R: jnp.ndarray     # (3,3) optimized pose
    pose_t: jnp.ndarray     # (3,)
    inliers: jnp.ndarray    # (N,) per-keypoint inlier mask
    n_inliers: jnp.ndarray  # ()
    Xw_kp: jnp.ndarray      # (N,3) per-keypoint map positions (TWM-bound)
    bound_kp: jnp.ndarray   # (N,) bool keypoint got a TWM binding


@functools.partial(jax.jit, static_argnames=("config",))
def twm_step(
    kl: Keypoints,
    u_right: jnp.ndarray,
    config: OrbConfig,
    bf: jnp.ndarray,
    cam: Camera,
    T0: SE3,                  # predicted pose
    q7: jnp.ndarray,          # (7, M) [u, v, radius, lmin, lmax, valid, angle]
    q_rows: jnp.ndarray,      # (M,) int32 PointStore rows (invalid -> 0, gated by q7[5])
    store_pos: jnp.ndarray,   # (cap, 3) device-resident map mirror
    store_desc: jnp.ndarray,  # (cap, 256) int8
) -> TwmStepOut:
    """TrackWithMotionModel search + widen-retry + pose optimization as one
    program. The widen-2x retry (Tracking.cc:2964) is folded in: both window
    gatings are evaluated (the Hamming matmul dominates and is shared work
    conceptually; at these sizes running the search twice is noise) and the
    wide result is selected when the narrow one has <20 matches.

    Map-point descriptors/positions come from the DEVICE-RESIDENT PointStore
    mirror (tracker._store_device; the reference's persistent CudaMapPoint
    mirrors, CudaFrame.cu:77-181) — per frame the host uploads only row
    indices, not megabytes of descriptors."""
    scale_factors = jnp.asarray(
        [config.scale_factor**l for l in range(config.n_levels)],
        dtype=jnp.float32,
    )
    q_desc = jnp.take(store_desc, q_rows, axis=0)
    q_pos = jnp.take(store_pos, q_rows, axis=0)

    def run_match(widen):
        res = search_by_projection(
            q7[0], q7[1], q_desc, q7[2] * widen,
            q7[3].astype(jnp.int32), q7[4].astype(jnp.int32), q7[5] > 0.5,
            kl.x, kl.y, kl.desc_signed, kl.level, kl.valid,
        )
        keep = rotation_consistency(q7[6], kl.angle, res)
        keep = keep & resolve_duplicates(res._replace(ok=keep), kl.x.shape[0])
        return res.idx, keep

    idx1, keep1 = run_match(1.0)
    idx2, keep2 = run_match(2.0)
    use_narrow = jnp.sum(keep1.astype(jnp.int32)) >= 20
    idx = jnp.where(use_narrow, idx1, idx2)
    keep = jnp.where(use_narrow, keep1, keep2)

    # scatter query -> keypoint (keep rows are unique post-dedup; non-keep
    # rows go to the dump slot N)
    N = kl.x.shape[0]
    idx_safe = jnp.where(keep, idx, N)
    Xw_kp = jnp.zeros((N + 1, 3), q_pos.dtype).at[idx_safe].set(q_pos)[:N]
    bound_kp = jnp.zeros(N + 1, bool).at[idx_safe].set(True)[:N]

    obs_uv = jnp.stack([kl.x, kl.y], -1)
    inv_sigma2 = 1.0 / (scale_factors[kl.level] ** 2)
    opt = pose_optimize(
        cam, bf, T0, Xw_kp, obs_uv, u_right, inv_sigma2, bound_kp
    )
    return TwmStepOut(
        idx, keep, opt.pose.R, opt.pose.t, opt.inliers, opt.n_inliers,
        Xw_kp, bound_kp,
    )


class TlmStepOut(NamedTuple):
    idx: jnp.ndarray         # (P,) matched keypoint per candidate
    keep: jnp.ndarray        # (P,) bool
    pose_R: jnp.ndarray
    pose_t: jnp.ndarray
    inliers: jnp.ndarray     # (N,) final per-keypoint inlier mask
    n_inliers: jnp.ndarray
    in_frustum: jnp.ndarray  # (P,) bool (feeds MapPoint::IncreaseVisible)
    pred_level: jnp.ndarray  # (P,) int32 predicted octave


@functools.partial(jax.jit, static_argnames=("config",))
def tlm_step(
    kl: Keypoints,
    u_right: jnp.ndarray,
    config: OrbConfig,
    bf: jnp.ndarray,
    cam: Camera,
    twm: TwmStepOut,          # device-resident output of twm_step
    cand_rows: jnp.ndarray,   # (P,) int32 PointStore rows (invalid -> 0)
    cand_ok: jnp.ndarray,     # (P,) bool
    store_pos: jnp.ndarray,   # device-resident PointStore mirror
    store_desc: jnp.ndarray,
    store_normal: jnp.ndarray,
    store_mind: jnp.ndarray,
    store_maxd: jnp.ndarray,
) -> TlmStepOut:
    """TrackLocalMap with the frustum cull ON DEVICE against the
    TWM-optimized pose (Frame::isInFrustum semantics, Tracking.cc:3472),
    then the taken-masked window match and the final pose optimization over
    the union of TWM + TLM bindings — no host involvement."""
    scale_factors = jnp.asarray(
        [config.scale_factor**l for l in range(config.n_levels)],
        dtype=jnp.float32,
    )
    cand_pos = jnp.take(store_pos, cand_rows, axis=0)
    cand_desc = jnp.take(store_desc, cand_rows, axis=0)
    cand_normal = jnp.take(store_normal, cand_rows, axis=0)
    cand_mind = jnp.take(store_mind, cand_rows)
    cand_maxd = jnp.take(store_maxd, cand_rows)
    R_cw, t_cw = twm.pose_R, twm.pose_t
    t_wc = -R_cw.T @ t_cw

    Xc = cand_pos @ R_cw.T + t_cw
    uv = project(cam, Xc)
    dist = jnp.linalg.norm(Xc, axis=-1)
    view = (cand_pos - t_wc) / jnp.maximum(dist, 1e-9)[:, None]
    in_img = (
        (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
        & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height)
    )
    in_frustum = (
        cand_ok
        & (Xc[:, 2] > 0.1)
        & in_img
        & (dist >= 0.8 * cand_mind)
        & (dist <= 1.2 * cand_maxd)
        & (jnp.sum(cand_normal * view, axis=-1) >= 0.5)
    )
    # MapPoint::PredictScale
    ratio = cand_maxd / jnp.maximum(dist, 1e-9)
    lv = jnp.ceil(
        jnp.log(jnp.maximum(ratio, 1e-9)) / jnp.log(config.scale_factor)
    )
    lv = jnp.clip(lv, 0, config.n_levels - 1).astype(jnp.int32)
    # RadiusByViewingCos (ORBmatcher.cc:141): 2.5 px head-on, 4.0 oblique
    view_cos = jnp.sum(cand_normal * view, axis=-1)
    radius = jnp.where(view_cos > 0.998, 2.5, 4.0) * scale_factors[lv]

    taken = twm.bound_kp & twm.inliers
    idx, keep = tlm_match(
        uv[:, 0], uv[:, 1], cand_desc, radius,
        jnp.maximum(lv - 1, 0), lv, in_frustum,
        kl.x, kl.y, kl.desc_signed, kl.level, kl.valid, taken,
    )

    # union of bindings for the final pose optimization
    N = kl.x.shape[0]
    idx_safe = jnp.where(keep, idx, N)
    Xw_kp = twm.Xw_kp
    Xw_kp = jnp.concatenate([Xw_kp, jnp.zeros((1, 3), Xw_kp.dtype)])
    Xw_kp = Xw_kp.at[idx_safe].set(cand_pos)[:N]
    bound = jnp.concatenate([taken, jnp.zeros(1, bool)])
    bound = bound.at[idx_safe].set(True)[:N]

    obs_uv = jnp.stack([kl.x, kl.y], -1)
    inv_sigma2 = 1.0 / (scale_factors[kl.level] ** 2)
    opt = pose_optimize(
        cam, bf, SE3(R_cw, t_cw), Xw_kp, obs_uv, u_right, inv_sigma2, bound
    )
    return TlmStepOut(
        idx, keep, opt.pose.R, opt.pose.t, opt.inliers, opt.n_inliers,
        in_frustum, lv,
    )


class TlmStepVIOut(NamedTuple):
    idx: jnp.ndarray
    keep: jnp.ndarray
    R_wb: jnp.ndarray        # optimized body state
    p_w: jnp.ndarray
    v_w: jnp.ndarray
    bg: jnp.ndarray
    ba: jnp.ndarray
    inliers: jnp.ndarray     # (N,) final per-keypoint inlier mask
    n_inliers: jnp.ndarray
    in_frustum: jnp.ndarray
    H: jnp.ndarray           # (15,15) marginal info for the next frame


@functools.partial(jax.jit, static_argnames=("config",))
def tlm_step_vi(
    kl: Keypoints,
    u_right: jnp.ndarray,
    config: OrbConfig,
    bf: jnp.ndarray,
    cam: Camera,
    twm: TwmStepOut,
    cand_rows: jnp.ndarray,
    cand_ok: jnp.ndarray,
    store_pos: jnp.ndarray,
    store_desc: jnp.ndarray,
    store_normal: jnp.ndarray,
    store_mind: jnp.ndarray,
    store_maxd: jnp.ndarray,
    R_bc: jnp.ndarray,
    t_bc: jnp.ndarray,
    vi_buf: jnp.ndarray,      # (547,) packed [prev state(21), prior_H(225),
                              #   preintegration(298), v0(3)] — one upload
) -> TlmStepVIOut:
    """Inertial TrackLocalMap stage: frustum + taken-masked match against
    the TWM visual pose (the reference's split — TrackWithMotionModel runs
    the VISUAL pose optimization, Tracking.cc:2989; the VI optimization
    happens once in TrackLocalMap, :3080-3106), then
    PoseInertialOptimizationLastFrame over the union of bindings with the
    ConstraintPoseImu soft anchor prior."""
    from fasttrack_tpu.imu.preintegration import unpack_preintegrated
    from fasttrack_tpu.optim.inertial import (
        BodyState, cam_to_body, pose_inertial_optimize_lastframe,
    )

    scale_factors = jnp.asarray(
        [config.scale_factor**l for l in range(config.n_levels)],
        dtype=jnp.float32,
    )
    cand_pos = jnp.take(store_pos, cand_rows, axis=0)
    cand_desc = jnp.take(store_desc, cand_rows, axis=0)
    cand_normal = jnp.take(store_normal, cand_rows, axis=0)
    cand_mind = jnp.take(store_mind, cand_rows)
    cand_maxd = jnp.take(store_maxd, cand_rows)
    R_cw, t_cw = twm.pose_R, twm.pose_t
    t_wc = -R_cw.T @ t_cw

    Xc = cand_pos @ R_cw.T + t_cw
    uv = project(cam, Xc)
    dist = jnp.linalg.norm(Xc, axis=-1)
    view = (cand_pos - t_wc) / jnp.maximum(dist, 1e-9)[:, None]
    in_img = (
        (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
        & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height)
    )
    in_frustum = (
        cand_ok
        & (Xc[:, 2] > 0.1)
        & in_img
        & (dist >= 0.8 * cand_mind)
        & (dist <= 1.2 * cand_maxd)
        & (jnp.sum(cand_normal * view, axis=-1) >= 0.5)
    )
    ratio = cand_maxd / jnp.maximum(dist, 1e-9)
    lv = jnp.ceil(
        jnp.log(jnp.maximum(ratio, 1e-9)) / jnp.log(config.scale_factor)
    )
    lv = jnp.clip(lv, 0, config.n_levels - 1).astype(jnp.int32)
    # RadiusByViewingCos (ORBmatcher.cc:141): 2.5 px head-on, 4.0 oblique
    view_cos = jnp.sum(cand_normal * view, axis=-1)
    radius = jnp.where(view_cos > 0.998, 2.5, 4.0) * scale_factors[lv]

    taken = twm.bound_kp & twm.inliers
    idx, keep = tlm_match(
        uv[:, 0], uv[:, 1], cand_desc, radius,
        jnp.maximum(lv - 1, 0), lv, in_frustum,
        kl.x, kl.y, kl.desc_signed, kl.level, kl.valid, taken,
    )

    N = kl.x.shape[0]
    idx_safe = jnp.where(keep, idx, N)
    Xw_kp = jnp.concatenate([twm.Xw_kp, jnp.zeros((1, 3), twm.Xw_kp.dtype)])
    Xw_kp = Xw_kp.at[idx_safe].set(cand_pos)[:N]
    bound = jnp.concatenate([taken, jnp.zeros(1, bool)])
    bound = bound.at[idx_safe].set(True)[:N]

    # VI motion-only optimization seeded at the TWM visual pose
    prev = BodyState(
        vi_buf[0:9].reshape(3, 3), vi_buf[9:12], vi_buf[12:15],
        vi_buf[15:18], vi_buf[18:21],
    )
    prior_H = vi_buf[21:246].reshape(15, 15)
    pre = unpack_preintegrated(vi_buf[246:544])
    v0 = vi_buf[544:547]
    R_wb0, p_w0 = cam_to_body(R_cw, t_cw, R_bc, t_bc)
    s0 = BodyState(R_wb0, p_w0, v0, prev.bg, prev.ba)
    obs_uv = jnp.stack([kl.x, kl.y], -1)
    inv_sigma2 = 1.0 / (scale_factors[kl.level] ** 2)
    res = pose_inertial_optimize_lastframe(
        cam, bf, R_bc, t_bc, prev, prior_H, pre, s0,
        Xw_kp, obs_uv, u_right, inv_sigma2, bound,
    )
    st = res.state
    return TlmStepVIOut(
        idx, keep, st.R_wb, st.p_w, st.v_w, st.bg, st.ba,
        res.inliers, res.n_inliers, in_frustum, res.H,
    )


@jax.jit
def pack_fused_vi_for_host(fd, twm: TwmStepOut, tlm: TlmStepVIOut):
    """pack_fused_for_host for the inertial frame: the tail carries the
    optimized body state + the 15x15 marginal prior for the next frame."""
    k = fd.kps
    f32 = jnp.stack([
        k.x, k.y, k.level.astype(jnp.float32), k.angle,
        fd.u_right, fd.depth, k.valid.astype(jnp.float32),
        twm.inliers.astype(jnp.float32), tlm.inliers.astype(jnp.float32),
    ])
    seg16 = jnp.concatenate([
        twm.idx.astype(jnp.float16), twm.keep.astype(jnp.float16),
        tlm.idx.astype(jnp.float16), tlm.keep.astype(jnp.float16),
        tlm.in_frustum.astype(jnp.float16),
    ])
    tail = jnp.concatenate([
        tlm.R_wb.reshape(-1), tlm.p_w, tlm.v_w, tlm.bg, tlm.ba,
        twm.n_inliers[None].astype(jnp.float32),
        tlm.n_inliers[None].astype(jnp.float32),
        tlm.H.reshape(-1),
    ])
    b1 = jax.lax.bitcast_convert_type(f32, jnp.uint8).reshape(-1)
    b2 = k.desc_packed.reshape(-1)
    b3 = jax.lax.bitcast_convert_type(seg16, jnp.uint8).reshape(-1)
    b4 = jax.lax.bitcast_convert_type(tail, jnp.uint8).reshape(-1)
    return jnp.concatenate([b1, b2, b3, b4])


def unpack_fused_vi(buf, N: int, M: int, P: int):
    """Host-side inverse of pack_fused_vi_for_host. Returns
    (f32 block, packed desc, idxA, keepA, idxB, keepB, in_frustum,
    tail (23,) = [R_wb(9), p_w(3), v_w(3), bg(3), ba(3), n_inlA, n_inlB],
    H (15,15))."""
    import numpy as np

    o1 = 9 * N * 4
    o2 = o1 + N * 32
    o3 = o2 + (2 * M + 3 * P) * 2
    f32 = buf[:o1].view(np.float32).reshape(9, N)
    packed = buf[o1:o2].reshape(N, 32)
    seg = buf[o2:o3].view(np.float16)
    tail_all = buf[o3:o3 + (23 + 225) * 4].view(np.float32)
    idxA = seg[:M].astype(np.int64)
    keepA = seg[M:2 * M] > 0.5
    idxB = seg[2 * M:2 * M + P].astype(np.int64)
    keepB = seg[2 * M + P:2 * M + 2 * P] > 0.5
    in_frustum = seg[2 * M + 2 * P:2 * M + 3 * P] > 0.5
    return (f32, packed, idxA, keepA, idxB, keepB, in_frustum,
            tail_all[:23], tail_all[23:].reshape(15, 15))


@jax.jit
def pack_fused_for_host(fd, twm: TwmStepOut, tlm: TlmStepOut):
    """Pack every host-needed output of a fused frame into ONE uint8 buffer
    so the frame costs exactly one device->host transfer."""
    k = fd.kps
    f32 = jnp.stack([
        k.x, k.y, k.level.astype(jnp.float32), k.angle,
        fd.u_right, fd.depth, k.valid.astype(jnp.float32),
        twm.inliers.astype(jnp.float32), tlm.inliers.astype(jnp.float32),
    ])
    # index/mask segments as f16 (indices < 2048 are exact in f16; the pose
    # tail stays f32); the result payload is packed tight: 1-D segments, no
    # row padding.
    seg16 = jnp.concatenate([
        twm.idx.astype(jnp.float16), twm.keep.astype(jnp.float16),
        tlm.idx.astype(jnp.float16), tlm.keep.astype(jnp.float16),
        tlm.in_frustum.astype(jnp.float16),
    ])
    tail = jnp.concatenate([
        tlm.pose_R.reshape(-1), tlm.pose_t,
        twm.n_inliers[None].astype(jnp.float32),
        tlm.n_inliers[None].astype(jnp.float32),
    ])
    b1 = jax.lax.bitcast_convert_type(f32, jnp.uint8).reshape(-1)
    b2 = k.desc_packed.reshape(-1)
    b3 = jax.lax.bitcast_convert_type(seg16, jnp.uint8).reshape(-1)
    b4 = jax.lax.bitcast_convert_type(tail, jnp.uint8).reshape(-1)
    return jnp.concatenate([b1, b2, b3, b4])


def unpack_fused(buf, N: int, M: int, P: int):
    """Host-side inverse of pack_fused_for_host (pure NumPy views).

    Returns (f32 frame block (9,N), packed descriptors (N,32),
    idxA (M,), keepA (M,), idxB (P,), keepB (P,), in_frustum (P,),
    tail (14,) = [pose_R(9), pose_t(3), n_inlA, n_inlB])."""
    import numpy as np

    o1 = 9 * N * 4
    o2 = o1 + N * 32
    o3 = o2 + (2 * M + 3 * P) * 2
    f32 = buf[:o1].view(np.float32).reshape(9, N)
    packed = buf[o1:o2].reshape(N, 32)
    seg = buf[o2:o3].view(np.float16)
    tail = buf[o3:o3 + 14 * 4].view(np.float32)
    idxA = seg[:M].astype(np.int64)
    keepA = seg[M:2 * M] > 0.5
    idxB = seg[2 * M:2 * M + P].astype(np.int64)
    keepB = seg[2 * M + P:2 * M + 2 * P] > 0.5
    in_frustum = seg[2 * M + 2 * P:2 * M + 3 * P] > 0.5
    return f32, packed, idxA, keepA, idxB, keepB, in_frustum, tail
