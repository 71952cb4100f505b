"""Tracking front-end: the per-frame state machine (src/Tracking.cc).

Host-side orchestration of the device kernels, mirroring the reference's
Track() control flow (Tracking.cc:1851-2392):

    GrabImage -> process_stereo_frame (device)            [ORB + stereo]
    -> TrackWithMotionModel (device search + pose opt)    [Tracking.cc:2911]
       fallback TrackReferenceKeyFrame                    [Tracking.cc:2777]
    -> TrackLocalMap (host frustum cull -> device search
       -> pose opt unless bypassed)                       [Tracking.cc:3042]
    -> NeedNewKeyFrame / CreateNewKeyFrame                [Tracking.cc:3193]
    -> RECENTLY_LOST / LOST handling + new map in Atlas   [Tracking.cc:2038]

The five offload toggles (KernelConfig) select device vs host per stage;
pose_optimization=False bypasses pose optimization in TrackLocalMap
(Tracking.cc:3080-3106, the FastTrack ablation mode).
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional

import numpy as np
import jax.numpy as jnp

from fasttrack_tpu.cameras.models import Camera
from fasttrack_tpu.frame_pipeline import (
    process_stereo_frame,
    process_stereo_frame_stacked,
)
from fasttrack_tpu.geometry import SE3
from fasttrack_tpu.kernels import KernelConfig
from fasttrack_tpu.ops.extractor import OrbConfig
from fasttrack_tpu.ops.project_match import (
    TH_HIGH,
    tlm_match_packed,
    twm_match_packed,
)
from fasttrack_tpu.optim import pose_optimize
from fasttrack_tpu.slam_map import Atlas, KeyFrame, MapPoint
from fasttrack_tpu.stats import Stats


from fasttrack_tpu.nputils import device_fetch
from fasttrack_tpu.nputils import orthonormalize as _orthonormalize


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    RECENTLY_LOST = 3
    LOST = 4


@dataclasses.dataclass
class TrackedFrame:
    """Host snapshot of one processed frame."""

    frame_id: int
    timestamp: float
    kp_uv: np.ndarray        # (N, 2)
    kp_level: np.ndarray
    kp_angle: np.ndarray
    desc_packed: np.ndarray
    desc_signed: np.ndarray
    u_right: np.ndarray
    depth: np.ndarray
    valid: np.ndarray
    R_cw: np.ndarray = None
    t_cw: np.ndarray = None
    mp_ids: np.ndarray = None
    # Inertial state (world frame, body = IMU): set while tracking inertially.
    v_w: np.ndarray = None
    bg: np.ndarray = None
    ba: np.ndarray = None

    def __post_init__(self):
        if self.mp_ids is None:
            self.mp_ids = np.full(len(self.kp_uv), -1, dtype=np.int64)

    def pose_wc(self):
        return self.R_cw.T, -self.R_cw.T @ self.t_cw


class Tracker:
    def __init__(
        self,
        camera: Camera,
        orb_config: OrbConfig,
        bf: float,
        atlas: Atlas,
        kernel_config: KernelConfig | None = None,
        stats: Stats | None = None,
        local_mapper=None,
        th_depth_factor: float = 40.0,
        min_frames_between_kf: int = 0,
        max_frames_between_kf: int = 20,
        monocular: bool = False,
        imu_calib=None,
        stereo_rig=None,        # cameras.stereo.StereoRig for KB8 fisheye
    ):
        self.monocular = monocular
        self.stereo_rig = stereo_rig
        # --- inertial front-end state (Tracking.cc IMU members) ----------
        self.imu_calib = imu_calib            # imu.preintegration.ImuCalib
        self.use_imu = imu_calib is not None
        self.imu_queue: list = []             # (t, acc(3), gyro(3)) pending
        self.pre_from_kf = None               # Preintegrated since last KF
        self.pre_from_frame = None            # Preintegrated since last FRAME
        self._last_map_change = -1            # map.change_index snapshot
        self.last_imu_time: float | None = None
        self.bias = (np.zeros(3), np.zeros(3))  # (bg, ba) current estimate
        self.v_w = np.zeros(3)                # current world velocity (body)
        self._prior_H = None   # ConstraintPoseImu info of the last frame
        self._tlm_cand_ids = None  # local-map candidate ids for fused frames
        self.last_kf_state = None             # host BodyState of the ref KF
        self._init_reference: Optional[TrackedFrame] = None
        self.reloc_db = None      # KeyFrameDatabase (shared with loop closing)
        self.vocabulary = None
        self.camera = camera
        self.cfg = orb_config
        self.bf = float(bf)
        self.baseline = self.bf / float(np.asarray(camera.params)[0])
        self.th_depth = th_depth_factor * self.baseline
        self.atlas = atlas
        self.kcfg = kernel_config or KernelConfig()
        self.stats = stats or Stats()
        self.local_mapper = local_mapper
        self.state = TrackingState.NO_IMAGES_YET
        self.last_frame: Optional[TrackedFrame] = None
        self.velocity: Optional[tuple] = None  # (R, t) of Tcl (cur<-last)
        self.ref_kf_id: Optional[int] = None
        self.frame_id = 0
        self.last_kf_frame_id = 0
        self.min_frames = min_frames_between_kf
        self.max_frames = max_frames_between_kf
        self.n_inliers = 0
        self.lost_since: Optional[float] = None
        self.time_recently_lost = 5.0  # Tracking.cc:71
        self.localization_only = False  # System::ActivateLocalizationMode
        self.trajectory: list = []     # (timestamp, R_cw, t_cw)

        self._scale_factors = np.asarray(
            [orb_config.scale_factor**l for l in range(orb_config.n_levels)],
            np.float32,
        )
        self._inv_sigma2 = 1.0 / (self._scale_factors**2)
        # Device-resident scalar operands, staged once (each fresh jnp scalar
        # is its own host->device transfer).
        self._bf_dev = jnp.float32(self.bf)
        self._minz_dev = jnp.float32(self.baseline)
        if self.use_imu:
            self._Rbc_dev = jnp.asarray(np.asarray(imu_calib.R_bc), jnp.float32)
            self._tbc_dev = jnp.asarray(np.asarray(imu_calib.t_bc), jnp.float32)

    # ------------------------------------------------------------------ utils
    def _frame_device_arrays(self, frame: TrackedFrame):
        """Device-resident (x, y, desc, level, valid, angle) of the CURRENT
        frame if its FrameData is still live (no re-upload); falls back to
        uploading the host snapshot (e.g. relocalizing an older frame)."""
        fd = getattr(self, "_fd_dev", None)
        if fd is not None and frame.frame_id == self.frame_id:
            k = fd.kps
            return k.x, k.y, k.desc_signed, k.level, k.valid, k.angle
        return (
            jnp.asarray(frame.kp_uv[:, 0]), jnp.asarray(frame.kp_uv[:, 1]),
            jnp.asarray(frame.desc_signed),
            jnp.asarray(frame.kp_level.astype(np.int32)),
            jnp.asarray(frame.valid), jnp.asarray(frame.kp_angle),
        )

    def _snapshot(self, fd, timestamp) -> TrackedFrame:
        """Host snapshot in TWO device->host fetches (a packed f32 block +
        packed descriptors; frame_pipeline.pack_frame_for_host)."""
        from fasttrack_tpu.frame_pipeline import pack_frame_for_host

        f32_d, packed_d = pack_frame_for_host(fd)
        t_sync = time.perf_counter()
        f32, packed = device_fetch(f32_d, packed_d)
        self.stats.record("sync_ms", (time.perf_counter() - t_sync) * 1e3)
        self.stats.record_count("device_fetches", 1)
        bits = np.unpackbits(packed, axis=1, bitorder="little")
        return TrackedFrame(
            frame_id=self.frame_id,
            timestamp=timestamp,
            kp_uv=np.ascontiguousarray(f32[:2].T),
            kp_level=f32[2].astype(np.int32),
            kp_angle=f32[3],
            desc_packed=packed,
            desc_signed=(2 * bits.astype(np.int8) - 1),
            u_right=f32[4],
            depth=f32[5],
            valid=f32[6] > 0.5,
        )

    def _unproject(self, frame: TrackedFrame, idx: np.ndarray) -> np.ndarray:
        """Stereo/depth keypoints -> world points (host, float64, any camera
        model via cameras.host.unproject_np — KB8 fisheye included)."""
        from fasttrack_tpu.cameras.host import unproject_np

        rays = unproject_np(self.camera, frame.kp_uv[idx])  # z == 1
        Xc = rays * frame.depth[idx][:, None]
        R_wc, t_wc = frame.pose_wc()
        return Xc @ R_wc.T + t_wc

    # --------------------------------------------------------- inertial utils
    def grab_imu(self, samples):
        """Queue raw IMU samples (System::GrabImuData semantics). Each sample
        is (t, acc(3,), gyro(3,))."""
        for s in samples:
            t, acc, gyro = s
            self.imu_queue.append(
                (float(t), np.asarray(acc, np.float64), np.asarray(gyro, np.float64))
            )

    def _preintegrate_imu(self, timestamp: float):
        """Tracking::PreintegrateIMU (Tracking.cc:1681): integrate queued
        samples up to ``timestamp`` into the running since-last-KF
        preintegration.

        The running accumulation lives on the HOST (numpy, microseconds for
        per-frame sample counts): the tracker reads it every frame for the
        IMU prediction and keyframe storage, and keeping it device-resident
        cost ~11 device->host fetches per frame. The device optimizers get
        it as ONE packed upload (imu.preintegration.pack_preintegrated)."""
        from fasttrack_tpu.imu.preintegration import HostPreintegrated

        if getattr(self, "_last_preint_ts", None) == timestamp:
            return  # already integrated for this frame (fused-path fallback)
        self._last_preint_ts = timestamp
        take = [s for s in self.imu_queue if s[0] <= timestamp]
        self.imu_queue = [s for s in self.imu_queue if s[0] > timestamp]
        if self.pre_from_kf is None:
            self.pre_from_kf = HostPreintegrated(self.bias[0], self.bias[1])
        # frame-to-frame accumulation restarts every frame (feeds the
        # LastFrame-anchored VI pose optimization, Optimizer.cc:4875)
        self.pre_from_frame = HostPreintegrated(self.bias[0], self.bias[1])
        if not take:
            return
        t_prev = self.last_imu_time
        accs, gyrs, dts = [], [], []
        for t, acc, gyro in take:
            dt = (t - t_prev) if t_prev is not None else 1.0 / self.imu_calib.freq
            t_prev = t
            if dt <= 0:
                continue
            accs.append(acc)
            gyrs.append(gyro)
            dts.append(dt)
        if accs and t_prev < timestamp - 1e-9:
            # Close the interval exactly at the image timestamp with a
            # zero-order-hold partial step (Tracking.cc:1731-1772 tstep
            # split). Without this, sample/frame boundary jitter makes the
            # preintegration span != the visual state spacing, and the
            # gravity term of that mismatch (g*ddt ~ 0.05 m/s for one
            # 200 Hz sample) is a ~100-sigma systematic error that the VI
            # optimizer dumps into the accelerometer bias.
            accs.append(accs[-1])
            gyrs.append(gyrs[-1])
            dts.append(timestamp - t_prev)
            t_prev = timestamp
        self.last_imu_time = t_prev
        if not accs:
            return
        self.pre_from_kf.integrate(accs, gyrs, dts, self.imu_calib)
        self.pre_from_frame.integrate(accs, gyrs, dts, self.imu_calib)

    def _body_from_cam(self, R_cw, t_cw):
        """T_wb from T_cw (host). With X_b = R_bc X_c + t_bc (Calib.mTbc):
        R_wb = R_wc R_bc^T, p_w = C_w - R_wb t_bc, C_w = -R_wc t_cw."""
        R_bc = np.asarray(self.imu_calib.R_bc, np.float64)
        t_bc = np.asarray(self.imu_calib.t_bc, np.float64)
        R_wc = R_cw.T
        R_wb = R_wc @ R_bc.T
        return R_wb, -R_wc @ t_cw - R_wb @ t_bc

    def _cam_from_body(self, R_wb, p_w):
        R_bc = np.asarray(self.imu_calib.R_bc, np.float64)
        t_bc = np.asarray(self.imu_calib.t_bc, np.float64)
        R_cb = R_bc.T
        t_cb = -R_cb @ t_bc
        R_cw = R_cb @ R_wb.T
        t_cw = t_cb - R_cw @ p_w
        return R_cw, t_cw

    def _pre_host(self):
        """The running since-KF preintegration (already host-resident)."""
        return self.pre_from_kf

    def _predict_state_imu(self):
        """Tracking::PredictStateIMU (Tracking.cc:1795) on host numpy, from
        the last KF body state through the since-KF preintegration."""
        from fasttrack_tpu.imu.preintegration import GRAVITY_VALUE

        R1, p1, v1 = self.last_kf_state
        pre = self._pre_host()
        bg, ba = self.bias
        dbg = bg - pre.b0.bg
        dba = ba - pre.b0.ba
        from fasttrack_tpu.imu.init import _so3_exp

        dR = pre.dR @ _so3_exp(pre.JRg @ dbg)
        dV = pre.dV + pre.JVg @ dbg + pre.JVa @ dba
        dP = pre.dP + pre.JPg @ dbg + pre.JPa @ dba
        g = np.array([0.0, 0.0, -GRAVITY_VALUE])
        t = pre.dT
        R2 = R1 @ dR
        v2 = v1 + g * t + R1 @ dV
        p2 = p1 + v1 * t + 0.5 * g * t * t + R1 @ dP
        return R2, p2, v2

    def _imu_ready(self) -> bool:
        return (
            self.use_imu
            and self.atlas.current.imu_initialized
            and self.last_kf_state is not None
            and self.pre_from_kf is not None
        )

    # ------------------------------------------------------- main entry point
    def track_stereo(self, img_left, img_right, timestamp: float):
        t0 = time.perf_counter()
        if self.stereo_rig is not None and self.camera.kind == "kb8":
            # fisheye stereo path (Frame.cc:1115 fisheye ctor route)
            from fasttrack_tpu.frame_pipeline import process_fisheye_frame_stacked

            stacked = np.stack(
                [np.asarray(img_left, np.uint8), np.asarray(img_right, np.uint8)]
            )

            def dispatch_fisheye():
                return process_fisheye_frame_stacked(
                    jnp.asarray(stacked), self.cfg, self.stereo_rig
                )

            if self._fused_eligible():
                out = self._track_fused(dispatch_fisheye, timestamp, t0)
                if out is not NotImplemented:
                    return out
            return self._track_frame(dispatch_fisheye(), timestamp, t0)
        if not (self.kcfg.orb_extraction and self.kcfg.stereo_match):
            # At least one front-end stage runs on host: the ablation modes
            # of the reference's toggle matrix (ORBextractor.cc:1374,
            # Frame.cc:156 CPU branches).
            return self._track_stereo_host(img_left, img_right, timestamp, t0)
        # ONE uint8 host->device transfer for both cameras (float32 would 4x
        # the bytes — the cast happens on device inside extraction).
        stacked = np.stack(
            [np.asarray(img_left, np.uint8), np.asarray(img_right, np.uint8)]
        )

        def dispatch_stereo():
            return process_stereo_frame_stacked(
                jnp.asarray(stacked), self.cfg, self._bf_dev, self._minz_dev,
            )

        if self._fused_eligible():
            out = self._track_fused(dispatch_stereo, timestamp, t0)
            if out is not NotImplemented:
                return out
        return self._track_frame(dispatch_stereo(), timestamp, t0)

    # -------------------------------------------------- fused one-sync path
    def _fused_eligible(self) -> bool:
        """The single-sync frame path (fused_track module) covers the normal
        case: OK state, all device toggles on, pinhole stereo, local-map
        candidates cached from the previous frame; visual frames need the
        constant-velocity model, inertial frames an initialized IMU with the
        frame-to-frame anchor ready (prior + last-frame velocity).
        Everything else (init, reloc, ablations) stays stepwise."""
        base = (
            self.state == TrackingState.OK
            and not self.localization_only
            and self._tlm_cand_ids is not None
            and len(self._tlm_cand_ids) > 0
            and self.kcfg.search_local_points and self.kcfg.pose_estimation
            and self.kcfg.pose_optimization
            and self.camera.kind in ("pinhole", "kb8")
            and self.last_frame is not None
            and self.last_frame.R_cw is not None
            and int((self.last_frame.mp_ids >= 0).sum()) >= 10
        )
        if not base:
            return False
        if not self.use_imu:
            return self.velocity is not None
        return (
            self._imu_ready()
            and self._prior_H is not None
            and self.last_frame.v_w is not None
            and self.atlas.current.change_index == self._last_map_change
        )

    _TLM_CAP = 4096  # fixed candidate capacity (one XLA program)

    def _store_device(self, m):
        """Device-resident PointStore mirror (the reference's persistent
        CudaMapPoint arrays, CudaFrame.cu:77-181 / KernelController.cu:18-22):
        re-uploaded only when the map changed (BA write-back, loop
        correction, new points — all bump change_index or grow the store);
        between keyframes the fused path uploads row INDICES only."""
        st = m.store
        key = (id(m), m.change_index, st.n_rows, st.cap)
        if getattr(self, "_store_key", None) != key:
            self._store_dev = (
                jnp.asarray(st.pos.astype(np.float32)),
                jnp.asarray(st.desc_signed),
                jnp.asarray(st.normal.astype(np.float32)),
                jnp.asarray(st.min_dist.astype(np.float32)),
                jnp.asarray(np.where(
                    np.isfinite(st.max_dist), st.max_dist, 1e6
                ).astype(np.float32)),
            )
            self._store_key = key
        return self._store_dev

    def _pack_tlm_candidates(self, m):
        """Select the cached local-map candidate ids -> PointStore rows for
        tlm_step (the data itself lives in the device mirror; only the id
        SET is one frame stale)."""
        mp_ids = np.asarray(self._tlm_cand_ids, np.int64)
        rows_all = m.rows_for(mp_ids)
        sel = rows_all >= 0
        sel[np.cumsum(sel) > self._TLM_CAP] = False
        rows = rows_all[sel]
        st = m.store
        sel_desc = st.has_desc[rows]
        rows = rows[sel_desc]
        j = len(rows)
        if j == 0:
            return None
        P = self._TLM_CAP
        mids = np.full(P, -1, np.int64)
        rows_p = np.zeros(P, np.int32)
        okq = np.zeros(P, bool)
        mids[:j] = mp_ids[sel][sel_desc]
        rows_p[:j] = rows
        okq[:j] = True
        return mids, rows_p, okq, rows

    def _track_fused(self, dispatch_fd, timestamp: float, t0: float):
        """One-sync OK-state frame (fused_track module): host packs every
        query block from last-frame state + the motion prediction, dispatches
        the frame chain (``dispatch_fd``: stereo / fisheye / mono) ->
        TWM(match+opt) -> TLM(frustum+match+opt) -> pack asynchronously,
        then fetches ALL outputs in one batched round trip. Falls back
        (returns NotImplemented) when preconditions break, and resumes the
        stepwise pipeline on TWM failure using the already fetched
        snapshot."""
        from fasttrack_tpu.cameras.host import (
            frustum_depth_ok, in_image_np, project_np,
        )
        from fasttrack_tpu.fused_track import (
            pack_fused_for_host, pack_fused_vi_for_host, tlm_step,
            tlm_step_vi, twm_step, unpack_fused, unpack_fused_vi,
        )

        m = self.atlas.current
        with m.lock:
            last = self.last_frame
            dt = timestamp - last.timestamp
            if dt < 0 or (self.use_imu and dt > 3.0):
                return NotImplemented  # timestamp jumps take the stepwise path

            use_vi = self.use_imu
            if use_vi:
                # host preintegration (microseconds) + IMU prediction
                self._preintegrate_imu(timestamp)
                R_wb_pred, p_w_pred, v_pred = self._predict_state_imu()
                R_pred, t_pred = self._cam_from_body(R_wb_pred, p_w_pred)
            else:
                R_pred = self.velocity[0] @ last.R_cw
                t_pred = self.velocity[0] @ last.t_cw + self.velocity[1]

            # ---- TWM query block (host; all last-frame state)
            has_mp = last.mp_ids >= 0
            mids = last.mp_ids.copy()
            q_rows_raw = m.rows_for(mids)
            okq = (q_rows_raw >= 0) & has_mp
            okq[okq] &= m.store.has_desc[q_rows_raw[okq]]
            pos = np.zeros((len(mids), 3), np.float32)
            pos[okq] = m.store.pos[q_rows_raw[okq]]
            Xc = pos @ R_pred.T.astype(np.float32) + t_pred.astype(np.float32)
            uvp = project_np(self.camera, Xc)
            okq &= frustum_depth_ok(self.camera, Xc) & in_image_np(self.camera, uvp)
            radius = 7.0 * self._scale_factors[last.kp_level]
            lvl = last.kp_level
            q7 = np.stack([
                uvp[:, 0], uvp[:, 1], radius,
                np.maximum(lvl - 1, 0), np.minimum(lvl + 1, self.cfg.n_levels - 1),
                okq.astype(np.float64), last.kp_angle,
            ]).astype(np.float32)
            q_rows = np.where(okq, q_rows_raw, 0).astype(np.int32)

            cand = self._pack_tlm_candidates(m)
            if cand is None:
                return NotImplemented
            c_mids, c_rows_p, c_ok, c_rows = cand

            # ---- dispatch the full chain (async; no host syncs)
            store_dev = self._store_device(m)
            fd = dispatch_fd()
            T0 = SE3(jnp.asarray(R_pred, jnp.float32),
                     jnp.asarray(t_pred, jnp.float32))
            twm = twm_step(
                fd.kps, fd.u_right, self.cfg, self._bf_dev, self.camera, T0,
                jnp.asarray(q7), jnp.asarray(q_rows),
                store_dev[0], store_dev[1],
            )
            H_vi = None
            if use_vi:
                from fasttrack_tpu.imu.preintegration import pack_preintegrated

                R1, p1 = self._body_from_cam(last.R_cw, last.t_cw)
                vi_buf = np.concatenate([
                    np.asarray(R1, np.float32).ravel(),
                    np.asarray(p1, np.float32),
                    np.asarray(last.v_w, np.float32),
                    np.asarray(self.bias[0], np.float32),
                    np.asarray(self.bias[1], np.float32),
                    np.asarray(self._prior_H, np.float32).ravel(),
                    pack_preintegrated(self.pre_from_frame),
                    np.asarray(v_pred, np.float32),
                ]).astype(np.float32)
                tlm = tlm_step_vi(
                    fd.kps, fd.u_right, self.cfg, self._bf_dev, self.camera,
                    twm, jnp.asarray(c_rows_p), jnp.asarray(c_ok), *store_dev,
                    self._Rbc_dev, self._tbc_dev, jnp.asarray(vi_buf),
                )
                buf_d = pack_fused_vi_for_host(fd, twm, tlm)
            else:
                tlm = tlm_step(
                    fd.kps, fd.u_right, self.cfg, self._bf_dev, self.camera,
                    twm, jnp.asarray(c_rows_p), jnp.asarray(c_ok), *store_dev,
                )
                buf_d = pack_fused_for_host(fd, twm, tlm)
            t_sync = time.perf_counter()
            buf = device_fetch(buf_d)
            self.stats.record("sync_ms", (time.perf_counter() - t_sync) * 1e3)
            self.stats.record_count("device_fetches", 1)
            N = int(fd.kps.x.shape[0])
            if use_vi:
                (f32, packed, idxA, keepA, idxB, keepB, in_frustum,
                 tail, H_vi) = unpack_fused_vi(buf, N, len(mids), self._TLM_CAP)
            else:
                (f32, packed, idxA, keepA, idxB, keepB, in_frustum,
                 tail) = unpack_fused(buf, N, len(mids), self._TLM_CAP)

            # ---- host bookkeeping
            bits = np.unpackbits(packed, axis=1, bitorder="little")
            frame = TrackedFrame(
                frame_id=self.frame_id, timestamp=timestamp,
                kp_uv=np.ascontiguousarray(f32[:2].T),
                kp_level=f32[2].astype(np.int32), kp_angle=f32[3],
                desc_packed=packed, desc_signed=(2 * bits.astype(np.int8) - 1),
                u_right=f32[4], depth=f32[5], valid=f32[6] > 0.5,
            )
            inlB_kp = f32[8] > 0.5
            n_inlA = int(tail[21] if use_vi else tail[12])
            n_inlB = int(tail[22] if use_vi else tail[13])

            if n_inlA < 10:
                # TWM failed — resume the stepwise pipeline with the snapshot
                # we already paid for (reference-KF matching, reloc, ...)
                self._fd_dev = fd
                self.stats.record("orb_extraction", (time.perf_counter() - t0) * 1e3)
                out = self._track_prepared(frame, t0)
                self._fd_dev = None
                return out

            # TWM bindings, then TLM bindings (first-binding-wins for a mid
            # bound by both — the device taken-mask already prevents
            # keypoint-level duplicates)
            frame.mp_ids[:] = -1
            frame.mp_ids[idxA[keepA]] = mids[keepA]
            twm_bound = mids[keepA]
            selB = keepB & ~np.isin(c_mids, twm_bound) & (c_mids >= 0)
            frame.mp_ids[idxB[selB]] = c_mids[selB]
            # final pose-opt outlier unbind (Tracking.cc:2996-3038)
            frame.mp_ids[~inlB_kp & (frame.mp_ids >= 0)] = -1
            self.n_inliers = n_inlB
            if use_vi:
                R_wb = _orthonormalize(tail[:9].reshape(3, 3).astype(np.float64))
                p_w = tail[9:12].astype(np.float64)
                frame.R_cw, frame.t_cw = self._cam_from_body(R_wb, p_w)
                frame.v_w = tail[12:15].astype(np.float64)
                frame.bg = tail[15:18].astype(np.float64)
                frame.ba = tail[18:21].astype(np.float64)
                self.v_w = frame.v_w
                self.bias = (frame.bg, frame.ba)
                self._prior_H = H_vi.astype(np.float64)
                self._last_map_change = m.change_index
            else:
                frame.R_cw = _orthonormalize(
                    tail[:9].reshape(3, 3).astype(np.float64)
                )
                frame.t_cw = tail[9:12].astype(np.float64)
            ok = self.n_inliers >= 20

            # MapPoint::IncreaseVisible for frustum hits
            m.store.n_visible[c_rows[in_frustum[:len(c_rows)]]] += 1
            # refresh reference KF + next frame's candidate set
            if ok:
                _, mp_ids_next = self._local_map_ids(frame)
                self._tlm_cand_ids = mp_ids_next
            self._post_track(frame, ok)

        self.frame_id += 1
        self.last_frame = frame
        if frame.R_cw is not None:
            self.trajectory.append(
                (timestamp, frame.R_cw.copy(), frame.t_cw.copy())
            )
        self.stats.record("tracking_total", (time.perf_counter() - t0) * 1e3)
        return (frame.R_cw, frame.t_cw) if frame.R_cw is not None else None

    def _track_stereo_host(self, img_left, img_right, timestamp: float, t0):
        """Front end with per-stage host/device dispatch (the reference's
        KernelController run-status branches)."""
        from fasttrack_tpu.ops import host_kernels as hk

        scale_factors = self._scale_factors
        if self.kcfg.orb_extraction:
            # device extraction, host-visible copies for the host stages
            from fasttrack_tpu.ops.extractor import extract_orb_pair

            kl_d, kr_d, pyr_l, pyr_r = extract_orb_pair(
                jnp.asarray(img_left, jnp.float32),
                jnp.asarray(img_right, jnp.float32), self.cfg,
            )
            kl = hk.HostKeypoints(*[np.asarray(f) for f in (
                kl_d.x, kl_d.y, kl_d.xl, kl_d.yl, kl_d.level, kl_d.angle,
                kl_d.score, kl_d.desc_packed, kl_d.desc_signed, kl_d.valid)])
            kr = hk.HostKeypoints(*[np.asarray(f) for f in (
                kr_d.x, kr_d.y, kr_d.xl, kr_d.yl, kr_d.level, kr_d.angle,
                kr_d.score, kr_d.desc_packed, kr_d.desc_signed, kr_d.valid)])
            raw_l = np.asarray(pyr_l.raw)
            raw_r = np.asarray(pyr_r.raw)
        else:
            kl, raw_l, _ = hk.host_extract_orb_with_pyramid(img_left, self.cfg)
            kr, raw_r, _ = hk.host_extract_orb_with_pyramid(img_right, self.cfg)

        if self.kcfg.stereo_match:
            from fasttrack_tpu.frame_pipeline import _stereo_match_stage
            from fasttrack_tpu.ops.extractor import Keypoints

            def to_dev(k):
                return Keypoints(
                    jnp.asarray(k.x), jnp.asarray(k.y), jnp.asarray(k.xl),
                    jnp.asarray(k.yl), jnp.asarray(k.level),
                    jnp.asarray(k.angle), jnp.asarray(k.score),
                    jnp.asarray(k.desc_signed), jnp.asarray(k.desc_packed),
                    jnp.asarray(k.valid),
                )

            sm, _ = _stereo_match_stage(
                to_dev(kl), to_dev(kr), jnp.asarray(raw_l), jnp.asarray(raw_r),
                self.cfg, jnp.float32(self.bf), jnp.float32(self.baseline),
            )
            u_right = np.asarray(sm.u_right)
            depth = np.asarray(sm.depth)
        else:
            u_right, depth = hk.host_match_rectified(
                kl, kr, raw_l, raw_r, scale_factors, self.bf, self.baseline,
            )

        frame = TrackedFrame(
            frame_id=self.frame_id,
            timestamp=timestamp,
            kp_uv=np.stack([kl.x, kl.y], -1),
            kp_level=kl.level,
            kp_angle=kl.angle,
            desc_packed=kl.desc_packed,
            desc_signed=kl.desc_signed,
            u_right=u_right,
            depth=depth,
            valid=kl.valid,
        )
        self.stats.record("orb_extraction", (time.perf_counter() - t0) * 1e3)
        return self._track_prepared(frame, t0)

    def track_rgbd(self, img, depth_map, timestamp: float):
        from fasttrack_tpu.frame_pipeline import process_rgbd_frame

        t0 = time.perf_counter()
        fd = process_rgbd_frame(
            jnp.asarray(img, jnp.float32),
            jnp.asarray(depth_map, jnp.float32),
            self.cfg,
            jnp.float32(self.bf),
        )
        return self._track_frame(fd, timestamp, t0)

    def track_monocular(self, img, timestamp: float):
        from fasttrack_tpu.frame_pipeline import process_mono_frame

        t0 = time.perf_counter()
        img_u8 = np.asarray(img, np.uint8)

        def dispatch_mono():
            return process_mono_frame(
                jnp.asarray(img_u8).astype(jnp.float32), self.cfg
            )

        if self._fused_eligible():
            out = self._track_fused(dispatch_mono, timestamp, t0)
            if out is not NotImplemented:
                return out
        return self._track_frame(dispatch_mono(), timestamp, t0)

    def _track_frame(self, fd, timestamp: float, t0: float):
        frame = self._snapshot(fd, timestamp)
        # keep the device-resident keypoint arrays for this frame's matcher
        # calls (zero re-upload of the frame side; persistent residency,
        # KernelController.cu:100-117)
        self._fd_dev = fd
        self.stats.record("orb_extraction", (time.perf_counter() - t0) * 1e3)
        out = self._track_prepared(frame, t0)
        self._fd_dev = None
        return out

    def _track_prepared(self, frame: TrackedFrame, t0: float):
        timestamp = frame.timestamp
        # Timestamp-jump handling (Tracking.cc:1885-1912): a backwards jump
        # resets the active map; a large forward gap starts a fresh map in
        # the Atlas (the IMU integration across the gap is meaningless).
        if self.last_frame is not None and self.state not in (
            TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED
        ):
            dt = timestamp - self.last_frame.timestamp
            if dt < 0:
                self.stats.record_count("timestamp_jump_backwards", 1)
                self._reset_active_map()
            elif self.use_imu and dt > 3.0:
                self.stats.record_count("timestamp_jump_forward", 1)
                self._handle_lost()
        if self.use_imu:
            self._preintegrate_imu(timestamp)

        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            if self.monocular:
                self._monocular_initialization(frame)
            else:
                self._stereo_initialization(frame)
        else:
            self._track(frame)

        self.frame_id += 1
        self.last_frame = frame
        if frame.R_cw is not None:
            self.trajectory.append((timestamp, frame.R_cw.copy(), frame.t_cw.copy()))
        self.stats.record("tracking_total", (time.perf_counter() - t0) * 1e3)
        return (frame.R_cw, frame.t_cw) if frame.R_cw is not None else None

    # ------------------------------------------------- stereo initialization
    def _stereo_initialization(self, frame: TrackedFrame):
        """Tracking::StereoInitialization (Tracking.cc:2392): needs >500
        stereo-depth features; creates the first KF + map points."""
        good = frame.valid & (frame.depth > 0)
        if good.sum() < 100:
            self.state = TrackingState.NOT_INITIALIZED
            return
        frame.R_cw = np.eye(3)
        frame.t_cw = np.zeros(3)
        kf = self._make_keyframe(frame)
        m = self.atlas.current
        m.add_keyframe(kf)
        idx = np.where(good)[0]
        Xw = self._unproject(frame, idx)
        for i, x in zip(idx, Xw):
            mp = MapPoint(self.atlas.next_mp_id(), x, kf.kid, kf.kid)
            mp.add_observation(kf.kid, int(i))
            mp.desc_packed = frame.desc_packed[i]
            mp.desc_signed = frame.desc_signed[i]
            mp.update_normal_and_depth(
                {kf.kid: kf.center}, kf.center, int(frame.kp_level[i]),
                self.cfg.scale_factor, self.cfg.n_levels,
            )
            kf.mp_ids[i] = mp.mid
            frame.mp_ids[i] = mp.mid
            m.add_mappoint(mp)
        m.update_connections(kf)
        self.ref_kf_id = kf.kid
        self.last_kf_frame_id = self.frame_id
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf)
        self.state = TrackingState.OK

    # --------------------------------------------- monocular initialization
    def _monocular_initialization(self, frame: TrackedFrame):
        """Tracking::MonocularInitialization (Tracking.cc:2505) +
        CreateInitialMapMonocular (:2583): two-view reconstruction between a
        reference frame and the current frame; map scaled to median depth 1."""
        from fasttrack_tpu.ops.project_match import search_by_projection
        from fasttrack_tpu.optim.two_view import reconstruct_two_view

        n_min = 100
        if self._init_reference is None or frame.valid.sum() < n_min:
            self._init_reference = frame if frame.valid.sum() >= n_min else None
            self.state = TrackingState.NOT_INITIALIZED
            return
        ref = self._init_reference
        # SearchForInitialization (ORBmatcher.cc:747): level-0 features,
        # window radius 100, ratio 0.9.
        lvl0_ref = ref.valid & (ref.kp_level == 0)
        lvl0_cur = frame.valid & (frame.kp_level == 0)
        res = search_by_projection(
            jnp.asarray(ref.kp_uv[:, 0]), jnp.asarray(ref.kp_uv[:, 1]),
            jnp.asarray(ref.desc_signed),
            jnp.full(len(ref.kp_uv), 100.0),
            jnp.zeros(len(ref.kp_uv), jnp.int32),
            jnp.zeros(len(ref.kp_uv), jnp.int32),
            jnp.asarray(lvl0_ref),
            jnp.asarray(frame.kp_uv[:, 0]), jnp.asarray(frame.kp_uv[:, 1]),
            jnp.asarray(frame.desc_signed),
            jnp.asarray(frame.kp_level.astype(np.int32)),
            jnp.asarray(lvl0_cur),
            ratio=0.9,
        )
        ok = np.asarray(res.ok)
        idx = np.asarray(res.idx)
        if ok.sum() < n_min:
            self._init_reference = frame  # slide the reference forward
            return
        i1 = np.where(ok)[0]
        i2 = idx[i1]
        p = np.asarray(self.camera.params)
        K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
        tv = reconstruct_two_view(
            ref.kp_uv[i1].astype(np.float32), frame.kp_uv[i2].astype(np.float32), K
        )
        if not tv.success:
            return
        # Scale: median depth -> 1 (CreateInitialMapMonocular).
        good = tv.good_mask
        med_z = float(np.median(tv.points3d[good, 2]))
        if med_z <= 0:
            return
        scale = 1.0 / med_z
        X = tv.points3d * scale

        ref.R_cw = np.eye(3)
        ref.t_cw = np.zeros(3)
        frame.R_cw = tv.R
        frame.t_cw = tv.t * scale
        m = self.atlas.current
        kf1 = self._make_keyframe(ref)
        m.add_keyframe(kf1)
        kf2 = self._make_keyframe(frame)
        m.add_keyframe(kf2)
        for k in np.where(good)[0]:
            a, b = int(i1[k]), int(i2[k])
            mp = MapPoint(self.atlas.next_mp_id(), X[k], kf2.kid, kf1.kid)
            mp.add_observation(kf1.kid, a)
            mp.add_observation(kf2.kid, b)
            mp.desc_packed = frame.desc_packed[b]
            mp.desc_signed = frame.desc_signed[b]
            mp.update_normal_and_depth(
                {kf1.kid: kf1.center, kf2.kid: kf2.center}, kf2.center,
                int(frame.kp_level[b]), self.cfg.scale_factor, self.cfg.n_levels,
            )
            kf1.mp_ids[a] = mp.mid
            kf2.mp_ids[b] = mp.mid
            frame.mp_ids[b] = mp.mid
            m.add_mappoint(mp)
        m.update_connections(kf1)
        m.update_connections(kf2)
        self.ref_kf_id = kf2.kid
        self.last_kf_frame_id = self.frame_id
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf1)
            self.local_mapper.insert_keyframe(kf2)
        self._init_reference = None
        self.state = TrackingState.OK

    def _make_keyframe(self, frame: TrackedFrame) -> KeyFrame:
        kf = KeyFrame(
            self.atlas.next_kf_id(), frame.frame_id, frame.timestamp,
            frame.R_cw, frame.t_cw, frame.kp_uv, frame.kp_level, frame.kp_angle,
            frame.desc_packed, frame.desc_signed, frame.u_right, frame.depth,
            frame.valid,
        )
        if self.use_imu:
            self._finalize_keyframe_inertial(kf, frame)
        return kf

    def _finalize_keyframe_inertial(self, kf: KeyFrame, frame: TrackedFrame):
        """Attach the inertial state + since-last-KF preintegration to a new
        keyframe and restart the accumulation (Tracking::CreateNewKeyFrame
        inertial bookkeeping, Tracking.cc:3345)."""
        prev_id = getattr(self, "last_kf_id", None)
        kf.velocity = np.asarray(
            frame.v_w if frame.v_w is not None else self.v_w, np.float64
        )
        kf.imu_bias = (self.bias[0].copy(), self.bias[1].copy())
        kf.prev_kf_id = prev_id
        if prev_id is not None and self.pre_from_kf is not None:
            kf.preintegrated = self.pre_from_kf.copy()
        if prev_id is not None:
            prev = self.atlas.current.keyframes.get(prev_id)
            if prev is not None:
                prev.next_kf_id = kf.kid
        self.last_kf_id = kf.kid
        R_wb, p_w = self._body_from_cam(kf.R_cw, kf.t_cw)
        self.last_kf_state = (R_wb, p_w, np.asarray(kf.velocity, np.float64))
        # restart the since-KF accumulation at the current bias estimate
        from fasttrack_tpu.imu.preintegration import HostPreintegrated

        self.pre_from_kf = HostPreintegrated(self.bias[0], self.bias[1])

    # ------------------------------------------------------------- tracking
    def _track(self, frame: TrackedFrame):
        m = self.atlas.current
        with m.lock:
            ok = False
            if self.state == TrackingState.OK:
                if self.velocity is not None or self._imu_ready():
                    t0 = time.perf_counter()
                    ok = self._track_with_motion_model(frame)
                    self.stats.record("twm", (time.perf_counter() - t0) * 1e3)
                if not ok:
                    t0 = time.perf_counter()
                    ok = self._track_reference_keyframe(frame)
                    self.stats.record("trk", (time.perf_counter() - t0) * 1e3)
            elif self.state == TrackingState.RECENTLY_LOST:
                if self._imu_ready():
                    # Inertial dead-reckoning (Tracking.cc:2038-2069): keep
                    # publishing the IMU-predicted pose and keep trying to
                    # re-acquire the map visually.
                    R_wb, p_w, v_w = self._predict_state_imu()
                    frame.R_cw, frame.t_cw = self._cam_from_body(R_wb, p_w)
                    frame.v_w = v_w
                    ok = self._track_with_motion_model(frame)
                    if not ok:
                        ok = self._track_reference_keyframe(frame)
                    if not ok:
                        # Pure dead-reckoning frame: the predicted pose
                        # stands (set above), tracking stays RECENTLY_LOST,
                        # the trajectory stays continuous.
                        self.v_w = v_w
                else:
                    ok = self._track_reference_keyframe(frame)
                    if not ok:
                        ok = self._relocalization(frame)

            if ok:
                t0 = time.perf_counter()
                ok = self._track_local_map(frame)
                self.stats.record("tlm", (time.perf_counter() - t0) * 1e3)

            self._post_track(frame, ok)

    def _post_track(self, frame: TrackedFrame, ok: bool):
        """Shared frame postlude (assumes the map lock is held): state
        machine transition, velocity model, found counters, keyframe
        decision (Tracking.cc:2038-2389 tail of Track())."""
        if ok:
            self.state = TrackingState.OK
            self.lost_since = None
            # velocity = Tcw_cur * Twc_last (undefined right after an
            # atlas load: no last frame yet)
            if self.last_frame is not None and self.last_frame.R_cw is not None:
                R_wl, t_wl = self.last_frame.pose_wc()
                self.velocity = (
                    _orthonormalize(frame.R_cw @ R_wl),
                    frame.R_cw @ t_wl + frame.t_cw,
                )
            self._update_found_counters(frame)
            # Localization-only mode (System::ActivateLocalizationMode):
            # track against the frozen map, never insert keyframes.
            if not self.localization_only and self._need_new_keyframe(frame):
                self._create_new_keyframe(frame)
        else:
            if self.state == TrackingState.OK:
                self.state = TrackingState.RECENTLY_LOST
                self.lost_since = frame.timestamp
            elif (
                self.state == TrackingState.RECENTLY_LOST
                and self.lost_since is not None
                and frame.timestamp - self.lost_since > self.time_recently_lost
            ):
                self.state = TrackingState.LOST
                self._handle_lost()
            self.velocity = None
            self._prior_H = None
            self._tlm_cand_ids = None
            # keep last pose as estimate (unless IMU dead-reckoning
            # already produced a prediction for this frame)
            if frame.R_cw is None and self.last_frame.R_cw is not None:
                frame.R_cw = self.last_frame.R_cw.copy()
                frame.t_cw = self.last_frame.t_cw.copy()
        self.stats.record_count("track_ok", int(ok))

    def _reset_active_map(self):
        """Tracking::ResetActiveMap: wipe the current map and reinitialize
        (used for backwards timestamp jumps and the bad-IMU reset)."""
        m = self.atlas.current
        m.clear()
        m.imu_initialized = False
        self.state = TrackingState.NOT_INITIALIZED
        self.ref_kf_id = None
        self.velocity = None
        self.last_kf_state = None
        self.pre_from_kf = None
        self._prior_H = None
        self._init_reference = None

    def _handle_lost(self):
        """Tracking.cc:2071-2089: abandon small maps, else start a fresh map
        in the Atlas (to be merged back by loop closing). Bad-IMU guard
        (Tracking.cc:1862-1867 / LocalMapping.cc:138-146): losing track
        before the IMU initialized means the visual-inertial state is
        untrustworthy — reset the active map instead of keeping it."""
        m = self.atlas.current
        if self.use_imu and not m.imu_initialized:
            self.stats.record_count("bad_imu_reset", 1)
            self._reset_active_map()
            return
        if m.n_keyframes() <= 10:
            m.clear()
        self.atlas.create_new_map()
        self.state = TrackingState.NOT_INITIALIZED
        self.ref_kf_id = None
        self.velocity = None

    # ------------------------------------------- device matching sub-routines
    def _gather_map_points(self, mids: np.ndarray, m):
        """Return (positions, signed descs, valid) padded arrays for ids —
        one vectorized pass over the map's packed PointStore (no per-point
        Python; the packed arrays ARE the map, slam_map.map.PointStore)."""
        rows = m.rows_for(mids)
        sel = rows >= 0
        r = rows[sel]
        pos = np.zeros((len(mids), 3), np.float32)
        desc = np.zeros((len(mids), 256), np.int8)
        ok = np.zeros(len(mids), bool)
        pos[sel] = m.store.pos[r]
        desc[sel] = m.store.desc_signed[r]
        ok[sel] = m.store.has_desc[r]
        return pos, desc, ok

    def _packed_for(self, mids: np.ndarray, m, okq: np.ndarray) -> np.ndarray:
        """Packed uint8 descriptors for map-point ids (host matcher input)."""
        rows = m.rows_for(mids)
        sel = (rows >= 0) & okq
        packed = np.zeros((len(mids), 32), np.uint8)
        packed[sel] = m.store.desc_packed[rows[sel]]
        return packed

    def _track_with_motion_model(self, frame: TrackedFrame) -> bool:
        """Tracking.cc:2911 + the PoseEstimationKernel device search.
        With an initialized IMU the prediction comes from PredictStateIMU
        (Tracking.cc:2924-2933) instead of the constant-velocity model."""
        m = self.atlas.current
        last = self.last_frame
        if last is None:
            # freshly loaded atlas: no last frame yet — the reference-KF
            # matcher (BoW route) handles re-acquisition
            return False
        if self._imu_ready():
            R_wb, p_w, v_w = self._predict_state_imu()
            R_pred, t_pred = self._cam_from_body(R_wb, p_w)
            frame.v_w = v_w
        elif self.velocity is not None:
            R_pred = self.velocity[0] @ last.R_cw
            t_pred = self.velocity[0] @ last.t_cw + self.velocity[1]
        else:
            return False

        has_mp = last.mp_ids >= 0
        if has_mp.sum() < 10:
            return False
        mids = last.mp_ids.copy()
        pos, desc, okq = self._gather_map_points(mids, m)
        okq &= has_mp

        # Project with predicted pose (host: cheap; device does matching).
        # Camera-model-aware (pinhole or KB8), cameras.host.
        from fasttrack_tpu.cameras.host import (
            frustum_depth_ok, in_image_np, project_np,
        )

        Xc = pos @ R_pred.T.astype(np.float32) + t_pred.astype(np.float32)
        uvp = project_np(self.camera, Xc)
        u, v = uvp[:, 0], uvp[:, 1]
        okq &= frustum_depth_ok(self.camera, Xc) & in_image_np(self.camera, uvp)
        th = 7.0  # stereo radius (ORBmatcher th=7 for stereo/RGBD)
        radius = th * self._scale_factors[last.kp_level]
        lvl = last.kp_level
        lmin = np.maximum(lvl - 1, 0).astype(np.int32)
        lmax = np.minimum(lvl + 1, self.cfg.n_levels - 1).astype(np.int32)
        for widen in (1.0, 2.0):  # retry with doubled window (Tracking.cc:2964)
            if self.kcfg.pose_estimation:
                # per-kernel phase stats (the reference's REGISTER_STATS
                # wrap/H2D/exec/D2H split, StereoMatchKernel.cu:636-706)
                t_w = time.perf_counter()
                q7 = np.stack([
                    u, v, radius * widen, lmin, lmax,
                    okq.astype(np.float64), last.kp_angle,
                ]).astype(np.float32)
                kx, ky, kd, klvl, kvalid, kang = self._frame_device_arrays(frame)
                t_h = time.perf_counter()
                q7_d = jnp.asarray(q7)
                desc_d = jnp.asarray(desc)
                t_x = time.perf_counter()
                idx, keep = twm_match_packed(
                    q7_d, desc_d, kx, ky, kd, klvl, kvalid, kang,
                )
                t_d = time.perf_counter()
                idx, keep_np = device_fetch(idx, keep)
                t_e = time.perf_counter()
                self.stats.record("twm_wrap", (t_h - t_w) * 1e3)
                self.stats.record("twm_h2d", (t_x - t_h) * 1e3)
                self.stats.record("twm_exec", (t_d - t_x) * 1e3)
                self.stats.record("twm_d2h", (t_e - t_d) * 1e3)
                self.stats.record("sync_ms", (t_e - t_d) * 1e3)
                self.stats.record_count("device_fetches", 1)
            else:
                # host path (ORBmatcher.cc:1992 CPU branch of the
                # poseEstimation toggle)
                from fasttrack_tpu.ops.host_kernels import host_twm_match

                packed = self._packed_for(mids, m, okq)
                idx, keep_np = host_twm_match(
                    np.stack([u, v], -1).astype(np.float32), packed,
                    (radius * widen).astype(np.float32), lmin, lmax, okq,
                    frame.kp_uv.astype(np.float32), frame.desc_packed,
                    frame.kp_level.astype(np.int32), frame.valid,
                    last.kp_angle, frame.kp_angle,
                )
            n = int(keep_np.sum())
            if n >= 20:
                break
        if n < 20:
            return False

        idx_np = np.asarray(idx)
        frame.mp_ids[:] = -1
        frame.mp_ids[idx_np[keep_np]] = mids[keep_np]
        return self._optimize_frame_pose(frame, R_pred, t_pred, min_inliers=10)

    def _track_reference_keyframe(self, frame: TrackedFrame) -> bool:
        """Tracking.cc:2777: descriptor match to the reference KF (the
        reference uses BoW-accelerated matching; the dense Hamming matmul needs no
        acceleration structure) + pose optimization."""
        m = self.atlas.current
        kf = m.keyframes.get(self.ref_kf_id) if self.ref_kf_id is not None else None
        if kf is None:
            return False
        has_mp = kf.mp_ids >= 0
        if has_mp.sum() < 15:
            return False
        pos, desc, okq = self._gather_map_points(kf.mp_ids, m)
        okq &= has_mp
        # Brute-force ratio matching (SearchByBoW semantics, ratio 0.7).
        from fasttrack_tpu.ops.stereo_match import match_fisheye

        res = match_fisheye(
            jnp.asarray(desc), jnp.asarray(okq),
            jnp.asarray(frame.desc_signed), jnp.asarray(frame.valid),
            ratio=0.7, max_dist=TH_HIGH,
        )
        keep = np.asarray(res.valid)
        if keep.sum() < 15:
            return False
        frame.mp_ids[:] = -1
        frame.mp_ids[np.asarray(res.idx_right)[keep]] = kf.mp_ids[keep]
        lf = self.last_frame
        R0 = lf.R_cw if (lf is not None and lf.R_cw is not None) else kf.R_cw
        t0 = lf.t_cw if (lf is not None and lf.t_cw is not None) else kf.t_cw
        return self._optimize_frame_pose(frame, R0, t0, min_inliers=10)

    def _optimize_frame_pose(self, frame, R0, t0, min_inliers=10) -> bool:
        m = self.atlas.current
        bound = np.where(frame.mp_ids >= 0)[0]
        if len(bound) < min_inliers:
            return False
        N = len(frame.mp_ids)
        Xw = np.zeros((N, 3), np.float32)
        ok = np.zeros(N, bool)
        rows = m.rows_for(frame.mp_ids[bound])
        live = rows >= 0
        Xw[bound[live]] = m.store.pos[rows[live]]
        ok[bound[live]] = True
        if self._imu_ready():
            return self._optimize_frame_pose_inertial(
                frame, R0, t0, Xw, ok, min_inliers
            )
        res = pose_optimize(
            self.camera,
            jnp.float32(self.bf),
            SE3(jnp.asarray(R0, jnp.float32), jnp.asarray(t0, jnp.float32)),
            jnp.asarray(Xw),
            jnp.asarray(frame.kp_uv),
            jnp.asarray(frame.u_right),
            jnp.asarray(self._inv_sigma2[frame.kp_level]),
            jnp.asarray(ok),
        )
        t_sync = time.perf_counter()
        inl, n_inl, R_new, t_new = device_fetch(
            res.inliers, res.n_inliers, res.pose.R, res.pose.t
        )
        self.stats.record("sync_ms", (time.perf_counter() - t_sync) * 1e3)
        self.stats.record_count("device_fetches", 1)
        self.n_inliers = int(n_inl)
        # unbind outliers (Tracking.cc:2996-3038)
        frame.mp_ids[~inl] = -1
        if self.n_inliers < min_inliers:
            return False
        frame.R_cw = _orthonormalize(R_new.astype(np.float64))
        frame.t_cw = t_new.astype(np.float64)
        return True

    def _optimize_frame_pose_inertial(
        self, frame, R0, t0, Xw, ok, min_inliers
    ) -> bool:
        """Motion-only VI optimization. Anchor selection mirrors the
        reference (Tracking.cc:3080-3106): when the map changed since the
        previous frame, anchor on the last KEYFRAME
        (Optimizer::PoseInertialOptimizationLastKeyFrame, Optimizer.cc:4491,
        fixed anchor); otherwise anchor on the last FRAME with the
        frame-to-frame preintegration and the ConstraintPoseImu soft prior
        carried from that frame's own solve
        (PoseInertialOptimizationLastFrame, Optimizer.cc:4875)."""
        from fasttrack_tpu.imu.preintegration import pack_preintegrated
        from fasttrack_tpu.optim.inertial import (
            BodyState,
            pose_inertial_optimize_lastframe_packed,
            pose_inertial_optimize_packed,
        )

        m_now = self.atlas.current
        lf = self.last_frame
        map_updated = m_now.change_index != self._last_map_change
        self._last_map_change = m_now.change_index
        use_frame_anchor = (
            not map_updated
            and lf is not None and lf.R_cw is not None and lf.v_w is not None
            and self.pre_from_frame is not None
        )
        kf_bg, kf_ba = self.bias
        if use_frame_anchor:
            R1, p1 = self._body_from_cam(lf.R_cw, lf.t_cw)
            v1 = lf.v_w
            pre_anchor = self.pre_from_frame
        else:
            R1, p1, v1 = self.last_kf_state
            pre_anchor = self.pre_from_kf
        prev = BodyState(
            jnp.asarray(R1, jnp.float32), jnp.asarray(p1, jnp.float32),
            jnp.asarray(v1, jnp.float32), jnp.asarray(kf_bg, jnp.float32),
            jnp.asarray(kf_ba, jnp.float32),
        )
        R_wb0, p_w0 = self._body_from_cam(
            np.asarray(R0, np.float64), np.asarray(t0, np.float64)
        )
        v0 = frame.v_w if frame.v_w is not None else self.v_w
        s0 = BodyState(
            jnp.asarray(R_wb0, jnp.float32), jnp.asarray(p_w0, jnp.float32),
            jnp.asarray(v0, jnp.float32), jnp.asarray(kf_bg, jnp.float32),
            jnp.asarray(kf_ba, jnp.float32),
        )
        common = (
            jnp.asarray(Xw), jnp.asarray(frame.kp_uv),
            jnp.asarray(frame.u_right),
            jnp.asarray(self._inv_sigma2[frame.kp_level]),
            jnp.asarray(ok),
        )
        pre_buf = jnp.asarray(pack_preintegrated(pre_anchor))
        if use_frame_anchor and self._prior_H is not None:
            res = pose_inertial_optimize_lastframe_packed(
                self.camera, jnp.float32(self.bf),
                jnp.asarray(np.asarray(self.imu_calib.R_bc), jnp.float32),
                jnp.asarray(np.asarray(self.imu_calib.t_bc), jnp.float32),
                prev, jnp.asarray(self._prior_H, jnp.float32),
                pre_buf, s0, *common,
            )
        else:
            res = pose_inertial_optimize_packed(
                self.camera, jnp.float32(self.bf),
                jnp.asarray(np.asarray(self.imu_calib.R_bc), jnp.float32),
                jnp.asarray(np.asarray(self.imu_calib.t_bc), jnp.float32),
                prev, pre_buf, s0, *common,
            )
        t_sync = time.perf_counter()
        inl = np.asarray(res.inliers)
        self.stats.record("sync_ms", (time.perf_counter() - t_sync) * 1e3)
        self.stats.record_count("device_fetches", 1)
        self.n_inliers = int(res.n_inliers)
        frame.mp_ids[~inl] = -1
        if self.n_inliers < max(min_inliers, 1):
            self._prior_H = None
            return False
        if res.H is not None:
            self._prior_H = np.asarray(res.H, np.float64)
        R_wb = _orthonormalize(np.asarray(res.state.R_wb, np.float64))
        p_w = np.asarray(res.state.p_w, np.float64)
        frame.R_cw, frame.t_cw = self._cam_from_body(R_wb, p_w)
        frame.v_w = np.asarray(res.state.v_w, np.float64)
        frame.bg = np.asarray(res.state.bg, np.float64)
        frame.ba = np.asarray(res.state.ba, np.float64)
        self.v_w = frame.v_w
        self.bias = (frame.bg, frame.ba)
        return True

    # -------------------------------------------------------- relocalization
    def _relocalization(self, frame: TrackedFrame) -> bool:
        """Tracking::Relocalization (Tracking.cc:3798): BoW candidate
        keyframes -> descriptor matching -> RANSAC PnP -> pose refinement.
        Requires a place-recognition database (self.reloc_db, shared with
        loop closing)."""
        if self.reloc_db is None or self.vocabulary is None:
            return False
        from fasttrack_tpu.bow.vocabulary import quantize
        from fasttrack_tpu.ops.stereo_match import match_fisheye
        from fasttrack_tpu.optim.pnp import ransac_pnp

        m = self.atlas.current
        _, bow = quantize(self.vocabulary, frame.desc_signed, frame.valid)
        cands = self.reloc_db.detect_relocalization_candidates(bow, n_best=5)
        p = np.asarray(self.camera.params)
        for kid in cands:
            kf = m.keyframes.get(kid)
            if kf is None:
                continue
            has_mp = kf.mp_ids >= 0
            if has_mp.sum() < 15:
                continue
            pos, desc, okq = self._gather_map_points(kf.mp_ids, m)
            okq &= has_mp
            res = match_fisheye(
                jnp.asarray(desc), jnp.asarray(okq),
                jnp.asarray(frame.desc_signed), jnp.asarray(frame.valid),
                ratio=0.75,
            )
            keep = np.asarray(res.valid)
            if keep.sum() < 15:
                continue
            idxf = np.asarray(res.idx_right)[keep]
            X = pos[keep]
            uv = frame.kp_uv[idxf]
            from fasttrack_tpu.cameras.host import unproject_np

            rays = unproject_np(self.camera, uv)
            sig2 = (1.0 / self._inv_sigma2)[frame.kp_level[idxf]]
            pnp = ransac_pnp(X.astype(np.float64), rays, sig2, float(p[0]))
            if not pnp.success:
                continue
            frame.mp_ids[:] = -1
            frame.mp_ids[idxf[pnp.inliers]] = kf.mp_ids[keep][pnp.inliers]
            if not self._optimize_frame_pose(frame, pnp.R_cw, pnp.t_cw, min_inliers=10):
                continue
            # Widening-window refinement (Tracking.cc:3889-3975): when the
            # BoW seed leaves <50 inliers, re-project the candidate KF's map
            # points through the refined pose with a wide window, rebind,
            # and re-optimize; then once more with a narrow window.
            for window in (10.0, 3.0):
                if self.n_inliers >= 50:
                    break
                if self._reloc_projection_rebind(frame, kf, m, window):
                    self._optimize_frame_pose(
                        frame, frame.R_cw, frame.t_cw, min_inliers=10
                    )
            if self.n_inliers >= 50:
                self.ref_kf_id = kid
                return True
        return False

    def _reloc_projection_rebind(self, frame: TrackedFrame, kf, m,
                                 window: float) -> bool:
        """SearchByProjection(CurrentFrame, pKF, th, ...) for relocalization
        (ORBmatcher.cc:2087): project the candidate keyframe's map points
        with the current pose estimate and window-match unbound keypoints."""
        from fasttrack_tpu.cameras.host import (
            frustum_depth_ok, in_image_np, project_np,
        )
        from fasttrack_tpu.ops.host_kernels import host_search_by_projection

        has_mp = kf.mp_ids >= 0
        if frame.R_cw is None or has_mp.sum() == 0:
            return False
        mids = kf.mp_ids.copy()
        pos, _, okq = self._gather_map_points(mids, m)
        okq &= has_mp
        # skip points already bound to this frame
        bound = frame.mp_ids[frame.mp_ids >= 0]
        if len(bound):
            okq &= ~np.isin(mids, bound)
        Xc = pos @ frame.R_cw.T.astype(np.float32) + frame.t_cw.astype(np.float32)
        uv = project_np(self.camera, Xc)
        okq &= frustum_depth_ok(self.camera, Xc) & in_image_np(self.camera, uv)
        if not okq.any():
            return False
        lvl = kf.kp_level.astype(np.int32)
        radius = (window * self._scale_factors[lvl]).astype(np.float32)
        packed = self._packed_for(mids, m, okq)
        taken = frame.mp_ids >= 0
        idx, _, hit = host_search_by_projection(
            uv.astype(np.float32), packed, radius,
            np.maximum(lvl - 1, 0), np.minimum(lvl + 1, self.cfg.n_levels - 1),
            okq, frame.kp_uv.astype(np.float32), frame.desc_packed,
            frame.kp_level.astype(np.int32), frame.valid & ~taken,
            max_dist=TH_HIGH,
        )
        n_new = 0
        for q in np.where(hit)[0]:
            i = int(idx[q])
            if frame.mp_ids[i] < 0:
                frame.mp_ids[i] = mids[q]
                n_new += 1
        return n_new > 0

    # ---------------------------------------------------------- local map
    def _local_map_ids(self, frame: TrackedFrame):
        """UpdateLocalKeyFrames/Points (Tracking.cc:3571-3797): KFs observing
        current points + their covisible neighbors; then all their points."""
        m = self.atlas.current
        kf_counter: dict[int, int] = {}
        for mid in frame.mp_ids:
            if mid < 0:
                continue
            mp = m.mappoints.get(int(mid))
            if mp is None or mp.bad:
                continue
            for kf_id in mp.observations:
                kf_counter[kf_id] = kf_counter.get(kf_id, 0) + 1
        if not kf_counter:
            return [], np.empty(0, np.int64)
        # Deterministic neighbor expansion: strongest observers first (the
        # reference iterates mvpLocalKeyFrames in insertion order; a set walk
        # here made neighbor selection nondeterministic).
        seeds = sorted(kf_counter, key=lambda k: (-kf_counter[k], k))
        local_kfs = list(seeds)
        local_set = set(local_kfs)
        for kf_id in seeds[:80]:
            kf = m.keyframes.get(kf_id)
            if kf is None:
                continue
            for nid in kf.best_covisible(10):
                if nid not in local_set:
                    local_set.add(nid)
                    local_kfs.append(nid)
            if len(local_kfs) > 80:
                break
        self.ref_kf_id = seeds[0]
        mp_arrays = [
            m.keyframes[kf_id].mp_ids for kf_id in local_kfs
            if kf_id in m.keyframes
        ]
        if not mp_arrays:
            return local_kfs, np.empty(0, np.int64)
        allm = np.concatenate(mp_arrays)
        allm = allm[allm >= 0]
        # Dedupe PRESERVING covisibility order (seeds' points first): the
        # TLM candidate cap truncates this list, so sorted-by-id order would
        # keep the OLDEST map points instead of the ones covisible with the
        # current view — on long sessions the tracker would then search
        # against far-away history and starve the live view of candidates.
        _, first_idx = np.unique(allm, return_index=True)
        mp_ids = allm[np.sort(first_idx)]
        return local_kfs, mp_ids

    def _track_local_map(self, frame: TrackedFrame) -> bool:
        m = self.atlas.current
        _, mp_ids = self._local_map_ids(frame)
        self._tlm_cand_ids = mp_ids  # next fused frame's candidate set
        if len(mp_ids) == 0:
            return False

        # Host frustum cull (Frame::isInFrustum — the reference also does
        # this on host, Tracking.cc:3472) as ONE vectorized pass over the
        # map's packed PointStore; camera-model-aware projection via
        # cameras.host (works for pinhole and KB8 fisheye).
        from fasttrack_tpu.cameras.host import (
            frustum_depth_ok, in_image_np, project_np,
        )

        P_CAP = 4096
        rows_all = m.rows_for(mp_ids)
        sel = rows_all >= 0
        already = frame.mp_ids[frame.mp_ids >= 0]
        if len(already):
            sel &= ~np.isin(mp_ids, already)
        n_over = int(sel.sum()) - P_CAP
        if n_over > 0:
            self.stats.record_count("tlm_overflow_points", n_over)
            drop = np.where(sel)[0][P_CAP:]
            sel[drop] = False
        rows = rows_all[sel]
        mids_sel = mp_ids[sel]
        st = m.store
        sel_desc = st.has_desc[rows]
        rows = rows[sel_desc]
        mids_sel = mids_sel[sel_desc]
        j = len(rows)
        if j == 0:
            return self.n_inliers >= 30

        R_wc, t_wc = frame.pose_wc()
        pos_j = st.pos[rows]
        Xc = (pos_j - t_wc) @ R_wc
        uv = project_np(self.camera, Xc)
        dist = np.linalg.norm(Xc, axis=1)
        view = (pos_j - t_wc) / np.maximum(dist, 1e-9)[:, None]
        in_frustum = (
            frustum_depth_ok(self.camera, Xc)
            & in_image_np(self.camera, uv)
            & (dist >= 0.8 * st.min_dist[rows])
            & (dist <= 1.2 * st.max_dist[rows])
            & (np.sum(st.normal[rows] * view, axis=1) >= 0.5)
        )
        # visibility bookkeeping (MapPoint::IncreaseVisible)
        st.n_visible[rows[in_frustum]] += 1

        # predicted pyramid level (MapPoint::PredictScale), vectorized
        ratio = st.max_dist[rows] / np.maximum(dist, 1e-9)
        lv = np.ceil(
            np.log(np.maximum(ratio, 1e-9)) / np.log(self.cfg.scale_factor)
        )
        lv = np.clip(lv, 0, self.cfg.n_levels - 1).astype(np.int32)

        # pack into fixed-capacity arrays for the device matcher
        pos = np.zeros((P_CAP, 3), np.float32)
        desc = np.zeros((P_CAP, 256), np.int8)
        okq = np.zeros(P_CAP, bool)
        levels = np.zeros(P_CAP, np.int32)
        mids_arr = np.full(P_CAP, -1, np.int64)
        pos[:j] = pos_j
        desc[:j] = st.desc_signed[rows]
        okq[:j] = in_frustum
        levels[:j] = lv
        mids_arr[:j] = mids_sel
        u = np.zeros(P_CAP, np.float64)
        v = np.zeros(P_CAP, np.float64)
        u[:j] = uv[:, 0]
        v[:j] = uv[:, 1]
        # viewing-angle-dependent window (ORBmatcher::RadiusByViewingCos,
        # ORBmatcher.cc:141): nearly head-on points (cos > 0.998) search a
        # tight 2.5-px window, oblique ones 4.0 px, scaled by the predicted
        # pyramid level; th=1 (SearchLocalPoints default).
        view_cos = np.sum(st.normal[rows] * view, axis=1)
        r_base = np.full(P_CAP, 4.0, np.float64)
        r_base[:j] = np.where(view_cos > 0.998, 2.5, 4.0)
        radius = r_base * self._scale_factors[levels]
        taken = frame.mp_ids >= 0
        if self.kcfg.search_local_points:
            t_w = time.perf_counter()
            q6 = np.stack([
                u, v, radius, np.maximum(levels - 1, 0), levels,
                okq.astype(np.float64),
            ]).astype(np.float32)
            kx, ky, kd, klvl, kvalid, _ = self._frame_device_arrays(frame)
            t_h = time.perf_counter()
            q6_d = jnp.asarray(q6)
            desc_d = jnp.asarray(desc)
            taken_d = jnp.asarray(taken.astype(np.float32))
            t_x = time.perf_counter()
            idx, keep = tlm_match_packed(
                q6_d, desc_d, kx, ky, kd, klvl, kvalid, taken_d,
            )
            t_d = time.perf_counter()
            idx_np, keep_np = device_fetch(idx, keep)
            t_e = time.perf_counter()
            self.stats.record("slp_wrap", (t_h - t_w) * 1e3)
            self.stats.record("slp_h2d", (t_x - t_h) * 1e3)
            self.stats.record("slp_exec", (t_d - t_x) * 1e3)
            self.stats.record("slp_d2h", (t_e - t_d) * 1e3)
            self.stats.record("sync_ms", (t_e - t_d) * 1e3)
            self.stats.record_count("device_fetches", 1)
        else:
            # host path (ORBmatcher.cc:227 CPU branch of the
            # searchLocalPoints toggle)
            from fasttrack_tpu.ops.host_kernels import host_tlm_match

            packed = self._packed_for(mids_arr, m, okq)
            idx_np, keep_np = host_tlm_match(
                np.stack([u, v], -1).astype(np.float32), packed,
                radius.astype(np.float32),
                np.maximum(levels - 1, 0).astype(np.int32),
                levels.astype(np.int32), okq,
                frame.kp_uv.astype(np.float32), frame.desc_packed,
                frame.kp_level.astype(np.int32), frame.valid, taken,
            )
        frame.mp_ids[idx_np[keep_np]] = mids_arr[keep_np]

        # Pose optimization — bypassed when the toggle is off
        # (Tracking.cc:3080-3106).
        if self.kcfg.pose_optimization:
            ok = self._optimize_frame_pose(frame, frame.R_cw, frame.t_cw, min_inliers=15)
            if not ok:
                return False
        else:
            self.n_inliers = int((frame.mp_ids >= 0).sum())
        return self.n_inliers >= 20

    def _update_found_counters(self, frame: TrackedFrame):
        """MapPoint::IncreaseFound for every tracked point — one vectorized
        pass over the packed store."""
        m = self.atlas.current
        bound = frame.mp_ids[frame.mp_ids >= 0]
        rows = m.rows_for(bound)
        m.store.n_found[rows[rows >= 0]] += 1

    # ------------------------------------------------------------ keyframes
    def _need_new_keyframe(self, frame: TrackedFrame) -> bool:
        """Tracking.cc:3193 (simplified): reference ratio + frame spacing."""
        m = self.atlas.current
        kf = m.keyframes.get(self.ref_kf_id)
        if kf is None:
            return False
        # Inertial pre-init: insert a keyframe every 0.25 s so the temporal
        # chain densifies fast enough for IMU initialization
        # (Tracking.cc NeedNewKeyFrame inertial branch: >=0.25s pre-init).
        if self.use_imu and not m.imu_initialized:
            last_kf = m.keyframes.get(getattr(self, "last_kf_id", None))
            if last_kf is not None and frame.timestamp - last_kf.timestamp >= 0.25:
                return True
        min_obs = 3 if m.n_keyframes() > 2 else 2
        ref_matches = kf.tracked_map_points(m.mappoints, min_obs)
        if ref_matches == 0:
            # Fresh map: init-KF points have a single observation, which
            # would disable the inlier-ratio trigger entirely and let the
            # map go stale (observed: appearance drift then collapse).
            ref_matches = kf.tracked_map_points(m.mappoints, 1)
        # close stereo points tracked vs could-be-created
        close_tracked = int(
            ((frame.depth > 0) & (frame.depth < self.th_depth) & (frame.mp_ids >= 0)).sum()
        )
        close_new = int(
            ((frame.depth > 0) & (frame.depth < self.th_depth) & (frame.mp_ids < 0)).sum()
        )
        need_insert_close = (close_tracked < 100) and (close_new > 70)
        # mono needs denser keyframes (reference thRefRatio=0.9 monocular)
        th_ref = 0.9 if self.monocular else (0.75 if m.n_keyframes() > 2 else 0.4)
        c1a = self.frame_id >= self.last_kf_frame_id + self.max_frames
        c1b = self.frame_id >= self.last_kf_frame_id + self.min_frames
        c2 = (
            self.n_inliers < ref_matches * th_ref or need_insert_close
        ) and self.n_inliers > 15
        return (c1a or (c1b and need_insert_close)) or c2

    def _create_new_keyframe(self, frame: TrackedFrame):
        """Tracking.cc:3345: new KF + stereo map points for close features."""
        m = self.atlas.current
        kf = self._make_keyframe(frame)
        kf.mp_ids = frame.mp_ids.copy()
        m.add_keyframe(kf)
        for i, mid in enumerate(frame.mp_ids):
            if mid >= 0:
                mp = m.mappoints.get(int(mid))
                if mp is not None and not mp.bad:
                    mp.add_observation(kf.kid, i)
        # create close stereo points (sorted by depth, cap ~100 beyond th)
        cand = np.where(frame.valid & (frame.depth > 0) & (frame.mp_ids < 0))[0]
        cand = cand[np.argsort(frame.depth[cand])]
        created = 0
        for i in cand:
            if frame.depth[i] > self.th_depth and created > 100:
                break
            Xw = self._unproject(frame, np.asarray([i]))[0]
            mp = MapPoint(self.atlas.next_mp_id(), Xw, kf.kid, kf.kid)
            mp.add_observation(kf.kid, int(i))
            mp.desc_packed = frame.desc_packed[i]
            mp.desc_signed = frame.desc_signed[i]
            mp.update_normal_and_depth(
                {kf.kid: kf.center}, kf.center, int(frame.kp_level[i]),
                self.cfg.scale_factor, self.cfg.n_levels,
            )
            kf.mp_ids[i] = mp.mid
            frame.mp_ids[i] = mp.mid
            m.add_mappoint(mp)
            created += 1
        m.update_connections(kf)
        self.ref_kf_id = kf.kid
        self.last_kf_frame_id = self.frame_id
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf)
