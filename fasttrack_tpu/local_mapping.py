"""Local mapping back-end (src/LocalMapping.cc).

Per inserted keyframe (LocalMapping::Run loop, LocalMapping.cc:64-282):
recent-map-point culling, new-point triangulation (stereo points come from
the tracker; epipolar triangulation adds mono points), duplicate fusion,
local BA over the covisibility window (device Schur-complement solver), and
keyframe culling.

Runs either synchronously (deterministic tests) or as a background thread
with the same queue/abort protocol as the reference.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import jax.numpy as jnp

from fasttrack_tpu.cameras.models import Camera
from fasttrack_tpu.geometry import SE3
from fasttrack_tpu.optim import BAProblem, local_bundle_adjustment
from fasttrack_tpu.slam_map import Atlas, KeyFrame

# BA window capacities (fixed shapes -> one XLA compile).
BA_MAX_KFS = 16
BA_MAX_POINTS = 2048


def _merge_preintegrated(a, b):
    """Compose host preintegration snapshots: A (prev->mid) then B
    (mid->next) -> (prev->next). Analytic composition of the deltas and
    bias Jacobians (the reference re-integrates stored measurements,
    ImuTypes::MergePrevious; measurements aren't retained here so the
    first-order composition is used; covariance is summed, a conservative
    upper bound)."""
    import types

    def hat(v):
        return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])

    dR = a.dR @ b.dR
    dV = a.dV + a.dR @ b.dV
    dP = a.dP + a.dV * b.dT + a.dR @ b.dP
    JRg = b.dR.T @ a.JRg + b.JRg
    JVg = a.JVg - a.dR @ hat(b.dV) @ a.JRg + a.dR @ b.JVg
    JVa = a.JVa + a.dR @ b.JVa
    JPg = a.JPg + a.JVg * b.dT - a.dR @ hat(b.dP) @ a.JRg + a.dR @ b.JPg
    JPa = a.JPa + a.JVa * b.dT + a.dR @ b.JPa
    return types.SimpleNamespace(
        dT=a.dT + b.dT, dR=dR, dV=dV, dP=dP,
        JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
        C=a.C + b.C, b0=a.b0,
    )


def _body_from_cam_np(R_cw, t_cw, R_bc, t_bc):
    """Host body pose from camera pose (X_b = R_bc X_c + t_bc convention):
    R_wb = R_wc R_bc^T, p_w = -R_wc t_cw - R_wb t_bc."""
    R_wc = R_cw.T
    R_wb = R_wc @ R_bc.T
    return R_wb, -R_wc @ t_cw - R_wb @ t_bc


class LocalMapper:
    def __init__(self, atlas: Atlas, camera: Camera, bf: float,
                 scale_factor: float = 1.2, n_levels: int = 8,
                 run_async: bool = False, loop_closer=None,
                 imu_calib=None, tracker=None, monocular: bool = False,
                 mesh=None):
        self.atlas = atlas
        self.camera = camera
        self.bf = float(bf)
        self.mesh = mesh  # jax.sharding.Mesh: shard local BA over devices
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.inv_sigma2 = 1.0 / (scale_factor ** (2 * np.arange(n_levels)))
        self.loop_closer = loop_closer
        self.imu_calib = imu_calib          # enables the inertial back-end
        self.tracker = tracker              # for IMU-init state sync
        self.monocular = monocular
        self.imu_init_kfs = 6               # KFs needed before InitializeIMU
        self.imu_init_time = None           # timestamp of InitializeIMU
        self.recent_mp_ids: list[tuple[int, int]] = []  # (mp_id, first_kf)
        self.run_async = run_async
        self.abort_ba = False
        self._queue: queue.Queue = queue.Queue()
        self._stop = False
        self._idle = threading.Event()
        self._idle.set()
        self._thread = None
        if run_async:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    # ---------------------------------------------------------------- public
    def insert_keyframe(self, kf: KeyFrame):
        if self.run_async:
            self.abort_ba = True  # interrupt BA like mbAbortBA
            self._queue.put(kf)
        else:
            self.process_keyframe(kf)

    def queue_size(self) -> int:
        return self._queue.qsize()

    def is_idle(self) -> bool:
        return self._idle.is_set() and self._queue.empty()

    def stop(self):
        self._stop = True
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=10)

    def _run(self):
        while not self._stop:
            kf = self._queue.get()
            if kf is None:
                break
            self._idle.clear()
            try:
                with self.atlas.current.lock:
                    self.process_keyframe(kf)
            finally:
                self._idle.set()

    # ------------------------------------------------------------ processing
    def process_keyframe(self, kf: KeyFrame):
        m = self.atlas.current
        if kf.kid not in m.keyframes:
            return
        self.abort_ba = False
        self._track_new_points(kf)
        self._cull_recent_mappoints(kf)
        self._create_new_mappoints(kf)
        self._search_in_neighbors(kf)
        if m.n_keyframes() > 2:
            if self.imu_calib is not None and m.imu_initialized:
                self._local_inertial_ba(kf)
            else:
                self._local_ba(kf)
            self._cull_keyframes(kf)
        if self.imu_calib is not None and not m.imu_initialized:
            self._try_initialize_imu(kf)
        elif self.imu_calib is not None and self.imu_init_time is not None:
            # VIBA staging (LocalMapping.cc:181-242): full-map inertial BA
            # ~5 s and ~15 s after initialization refines scale/gravity/bias
            # once more motion has accumulated.
            dt = kf.timestamp - self.imu_init_time
            if not m.iniertial_ba1 and dt > 5.0:
                self._full_inertial_ba(kf)
                m.iniertial_ba1 = True
            elif m.iniertial_ba1 and not m.iniertial_ba2 and dt > 15.0:
                self._full_inertial_ba(kf)
                m.iniertial_ba2 = True
            elif self.monocular and not m.iniertial_ba2:
                # periodic monocular scale refinement until BA2 locks scale
                self._scale_kf_counter = getattr(self, "_scale_kf_counter", 0) + 1
                if self._scale_kf_counter % 10 == 0:
                    self._scale_refinement(kf)
        if self.loop_closer is not None and kf.kid in m.keyframes:
            self.loop_closer.insert_keyframe(kf)

    def _track_new_points(self, kf: KeyFrame):
        """LocalMapping::ProcessNewKeyFrame (LocalMapping.cc:298): register
        map points CREATED at this keyframe for the culling grace window (the
        reference's mlpRecentAddedMapPoints holds newly triangulated points,
        not re-observed ones, LocalMapping.cc:388); RE-observed points get a
        fresh distinctive descriptor + normal/depth, like the reference's
        UpdateNormalAndDepth + ComputeDistinctiveDescriptors calls there."""
        m = self.atlas.current
        for i, mid in enumerate(kf.mp_ids):
            if mid < 0:
                continue
            mp = m.mappoints.get(int(mid))
            if mp is None or mp.bad:
                continue
            if mp.first_kf_id == kf.kid and kf.kid != m.init_kf_id:
                # init points are not probationary
                self.recent_mp_ids.append((int(mid), kf.kid))
            elif mp.first_kf_id != kf.kid:
                m.refresh_mappoint(mp, self.scale_factor, self.n_levels)

    def _cull_recent_mappoints(self, kf: KeyFrame):
        """MapPointCulling (LocalMapping.cc:346): drop points with poor
        found/visible ratio or too few observations after a grace period."""
        m = self.atlas.current
        survivors = []
        for mid, first_kf in self.recent_mp_ids:
            mp = m.mappoints.get(mid)
            if mp is None or mp.bad:
                continue
            age = kf.kid - first_kf
            if mp.found_ratio() < 0.25:
                m.erase_mappoint(mid)
            elif age >= 2 and mp.n_obs() <= 2:
                m.erase_mappoint(mid)
            elif age >= 3:
                continue  # graduated
            else:
                survivors.append((mid, first_kf))
        self.recent_mp_ids = survivors

    # ------------------------------------------------- new point creation
    _EPI_BATCH = 10   # fixed neighbor-batch capacity (one XLA program)

    def _create_new_mappoints(self, kf: KeyFrame, n_neighbors: int = 10):
        """Epipolar triangulation of unmatched features with covisible
        keyframes (LocalMapping::CreateNewMapPoints, LocalMapping.cc:388).
        The stereo tracker also creates points from depth; this adds the
        far/mono points and is the ONLY source of points in monocular mode.

        ALL neighbor pairs run as ONE batched device program
        (ops.project_match.epipolar_match_tri_batch) — match + triangulate
        for up to _EPI_BATCH neighbors in a single dispatch + fetch, instead
        of two blocking round trips per neighbor (the keyframe-creation
        critical path).
        A second pass with refreshed free masks recovers the sequential
        loop's rebinding behavior (features bound by an earlier neighbor are
        re-matched by later ones), so point yield matches the per-neighbor
        ordering within noise."""
        if self.camera.kind != "pinhole":
            # Epipolar F-matrix gating is pinhole geometry; fisheye rigs get
            # their new points from triangulated stereo depth instead
            # (process_fisheye_frame_stacked), like the reference's KB8 route
            # which relies on TriangulateMatches depth (Frame.cc:1231-1306).
            return 0
        created = self._create_points_batched(kf, n_neighbors)
        if created:
            created += self._create_points_batched(kf, n_neighbors)
        return created

    def _create_points_batched(self, kf: KeyFrame, n_neighbors: int = 10):
        import jax.numpy as jnp

        from fasttrack_tpu.ops.project_match import epipolar_match_tri_batch
        from fasttrack_tpu.slam_map import MapPoint

        m = self.atlas.current
        p = np.asarray(self.camera.params)
        fx, fy, cx, cy = p[:4]
        Kmat = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        Kinv = np.linalg.inv(Kmat)
        sigma2 = self.inv_sigma2  # note: inv; variance = 1/inv

        # ---- collect neighbor pairs (host) --------------------------------
        nbs, F12s, R21s, t21s = [], [], [], []
        for nid in kf.best_covisible(n_neighbors):
            nb = m.keyframes.get(nid)
            if nb is None:
                continue
            # baseline check (LocalMapping.cc:437): skip near-identical views
            if np.linalg.norm(kf.center - nb.center) < 0.01:
                continue
            # fundamental F12 with x2^T F x1 = 0 (1 = neighbor, 2 = current)
            R21 = kf.R_cw @ nb.R_cw.T
            t21 = kf.t_cw - R21 @ nb.t_cw
            tx = np.array([[0, -t21[2], t21[1]], [t21[2], 0, -t21[0]],
                           [-t21[1], t21[0], 0]])
            F12s.append(Kinv.T @ (tx @ R21) @ Kinv)
            R21s.append(R21)
            t21s.append(t21)
            nbs.append(nb)
            if len(nbs) >= self._EPI_BATCH:
                break
        if not nbs:
            return 0

        # ---- pack to fixed shapes (B x C1 neighbors, C2 current) ----------
        def _cap(n):
            return max(256, int(np.ceil(n / 256)) * 256)

        B = self._EPI_BATCH
        C1 = _cap(max(len(nb.kp_uv) for nb in nbs))
        C2 = _cap(len(kf.kp_uv))
        u1 = np.zeros((B, C1), np.float32)
        v1 = np.zeros((B, C1), np.float32)
        d1 = np.zeros((B, C1, 256), np.int8)
        f1 = np.zeros((B, C1), bool)
        F12 = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        R21 = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        t21 = np.zeros((B, 3), np.float32)
        for b, nb in enumerate(nbs):
            n = len(nb.kp_uv)
            u1[b, :n] = nb.kp_uv[:, 0]
            v1[b, :n] = nb.kp_uv[:, 1]
            d1[b, :n] = nb.desc_signed
            f1[b, :n] = (nb.mp_ids < 0) & nb.valid
            F12[b] = F12s[b]
            R21[b] = R21s[b]
            t21[b] = t21s[b]
        n2 = len(kf.kp_uv)
        u2 = np.zeros(C2, np.float32)
        v2 = np.zeros(C2, np.float32)
        d2 = np.zeros((C2, 256), np.int8)
        f2 = np.zeros(C2, bool)
        var2 = np.ones(C2, np.float32)
        u2[:n2] = kf.kp_uv[:, 0]
        v2[:n2] = kf.kp_uv[:, 1]
        d2[:n2] = kf.desc_signed
        f2[:n2] = (kf.mp_ids < 0) & kf.valid
        var2[:n2] = (1.0 / sigma2)[kf.kp_level]

        idx2_b, keep_b, X1_b = epipolar_match_tri_batch(
            jnp.asarray(u1), jnp.asarray(v1), jnp.asarray(d1),
            jnp.asarray(f1), jnp.asarray(u2), jnp.asarray(v2),
            jnp.asarray(d2), jnp.asarray(f2), jnp.asarray(F12),
            jnp.asarray(var2), jnp.asarray(R21), jnp.asarray(t21),
            jnp.float32(fx), jnp.float32(fy), jnp.float32(cx),
            jnp.float32(cy),
        )
        idx2_b = np.asarray(idx2_b)
        keep_b = np.asarray(keep_b)
        X1_b = np.asarray(X1_b)

        # ---- validate + instantiate (host, per pair) -----------------------
        created = 0
        for b, nb in enumerate(nbs):
            keep = keep_b[b, : len(nb.kp_uv)]
            if not keep.any():
                continue
            i1 = np.where(keep)[0]
            i2 = idx2_b[b][i1]
            in_range = i2 < n2
            i1, i2 = i1[in_range], i2[in_range]
            if len(i1) == 0:
                continue
            X1 = X1_b[b][i1]
            # validations: finite, in front, parallax, reprojection
            z1 = X1[:, 2]
            X2 = X1 @ R21s[b].T + t21s[b]
            z2 = X2[:, 2]
            d1v = X1 / np.maximum(np.linalg.norm(X1, axis=1, keepdims=True), 1e-9)
            C2in1 = -R21s[b].T @ t21s[b]
            v2v = X1 - C2in1
            d2v = v2v / np.maximum(np.linalg.norm(v2v, axis=1, keepdims=True), 1e-9)
            cosp = np.sum(d1v * d2v, axis=1)
            pr1 = X1 @ Kmat.T
            pr1 = pr1[:, :2] / np.maximum(pr1[:, 2:], 1e-9)
            pr2 = X2 @ Kmat.T
            pr2 = pr2[:, :2] / np.maximum(pr2[:, 2:], 1e-9)
            e1 = ((pr1 - nb.kp_uv[i1]) ** 2).sum(1) * sigma2[nb.kp_level[i1]]
            e2 = ((pr2 - kf.kp_uv[i2]) ** 2).sum(1) * sigma2[kf.kp_level[i2]]
            good = (
                np.isfinite(X1).all(1) & (z1 > 0) & (z2 > 0)
                & (cosp < 0.9998) & (e1 < 5.991) & (e2 < 5.991)
            )
            R1w = nb.R_cw.T
            t1w = nb.center
            for k in np.where(good)[0]:
                a, c = int(i1[k]), int(i2[k])
                if nb.mp_ids[a] >= 0 or kf.mp_ids[c] >= 0:
                    continue
                Xw = R1w @ X1[k] + t1w
                mp = MapPoint(self.atlas.next_mp_id(), Xw, kf.kid, kf.kid)
                mp.add_observation(nb.kid, a)
                mp.add_observation(kf.kid, c)
                mp.desc_packed = kf.desc_packed[c]
                mp.desc_signed = kf.desc_signed[c]
                mp.update_normal_and_depth(
                    {nb.kid: nb.center, kf.kid: kf.center}, kf.center,
                    int(kf.kp_level[c]), self.scale_factor, self.n_levels,
                )
                nb.mp_ids[a] = mp.mid
                kf.mp_ids[c] = mp.mid
                m.add_mappoint(mp)
                self.recent_mp_ids.append((mp.mid, kf.kid))
                created += 1
        return created

    # ------------------------------------------------- duplicate-point fusion
    def _search_in_neighbors(self, kf: KeyFrame, n_neighbors: int = 10):
        """LocalMapping::SearchInNeighbors (LocalMapping.cc:714): project the
        current KF's map points into covisible neighbors (and one hop
        further) and fuse duplicates via ORBmatcher::Fuse semantics
        (ORBmatcher.cc:1247); then the reverse direction. Afterwards the
        current KF's points get fresh distinctive descriptors and normals
        (MapPoint::ComputeDistinctiveDescriptors / UpdateNormalAndDepth) and
        the covisibility graph is rebuilt."""
        m = self.atlas.current
        targets = []
        seen = {kf.kid}
        for nid in kf.best_covisible(n_neighbors):
            if nid in m.keyframes and nid not in seen:
                targets.append(nid)
                seen.add(nid)
        for nid in list(targets):
            for nid2 in m.keyframes[nid].best_covisible(5):
                if nid2 in m.keyframes and nid2 not in seen:
                    targets.append(nid2)
                    seen.add(nid2)
        if not targets:
            return 0

        n_fused = 0
        cur_mids = [int(x) for x in kf.mp_ids if x >= 0]
        for tid in targets:
            n_fused += self._fuse_into(m.keyframes[tid], cur_mids)
        back = sorted(
            {int(x) for tid in targets for x in m.keyframes[tid].mp_ids if x >= 0}
        )
        n_fused += self._fuse_into(kf, back)

        for mid in kf.mp_ids:
            if mid >= 0:
                mp = m.mappoints.get(int(mid))
                if mp is not None and not mp.bad:
                    m.refresh_mappoint(mp, self.scale_factor, self.n_levels)
        m.update_connections(kf)
        return n_fused

    def _fuse_into(self, tkf: KeyFrame, mids: list, th: float = 3.0) -> int:
        return fuse_mappoints_into(
            self.atlas.current, tkf, mids, self.camera,
            self.scale_factor, self.n_levels, th,
        )

    # ------------------------------------------------------------- local BA
    def _local_ba(self, kf: KeyFrame):
        """Covisibility-window BA (Optimizer.cc:1116 semantics): free window
        = current KF + best covisible; fixed frontier = outside KFs
        observing the window's points. Assembly/solve/writeback shared with
        global BA and dist-BA (ba_assembly.solve_window)."""
        from fasttrack_tpu.ba_assembly import assemble_window, write_back
        from fasttrack_tpu.optim import local_bundle_adjustment as solve

        m = self.atlas.current
        local_ids = [kf.kid] + kf.best_covisible(BA_MAX_KFS - 1)
        local_ids = [k for k in local_ids if k in m.keyframes]
        local_set = set(local_ids)

        # Window points + fixed frontier (KFs outside observing them).
        mp_ids = []
        seen = set()
        dropped = 0
        for kid in local_ids:
            for mid in m.keyframes[kid].mp_ids:
                if mid >= 0 and int(mid) not in seen:
                    mp = m.mappoints.get(int(mid))
                    if mp is not None and not mp.bad:
                        seen.add(int(mid))
                        if len(mp_ids) < BA_MAX_POINTS:
                            mp_ids.append(int(mid))
                        else:
                            dropped += 1
        if dropped:
            import logging

            logging.getLogger(__name__).info(
                "local_ba: window overflow, dropped %d points (cap %d)",
                dropped, BA_MAX_POINTS,
            )
        # Fixed frontier: the reference anchors EVERY outside KF observing a
        # window point (Optimizer.cc:1172). Under the fixed-shape KF cap we
        # rank frontier candidates by how many window points they observe so
        # truncation drops the WEAKEST anchors, not whichever came last in
        # iteration order (VERDICT r4: window edges could go unanchored).
        anchor_votes: dict[int, int] = {}
        for mid in mp_ids:
            for kid in m.mappoints[mid].observations:
                if kid not in local_set and kid in m.keyframes:
                    anchor_votes[kid] = anchor_votes.get(kid, 0) + 1
        budget = max(BA_MAX_KFS - len(local_ids), 0)
        fixed_ids = sorted(anchor_votes, key=lambda k: -anchor_votes[k])[:budget]
        if not fixed_ids and len(local_ids) > 1:
            # no frontier at all (young map): freeze the oldest window KF as
            # the gauge anchor so the window cannot drift freely
            oldest = min(local_ids)
            local_ids.remove(oldest)
            local_set.discard(oldest)
            fixed_ids = [oldest]

        prob, meta, _ = assemble_window(
            m, local_ids, fixed_ids,
            self.inv_sigma2, BA_MAX_KFS, BA_MAX_POINTS, mp_ids,
        )
        if self.mesh is not None:
            # Landmark-sharded Schur BA over the configured device mesh
            # (parallel/dist_ba.py): identical math, the reduced camera
            # system psum'd across the mesh, including the final chi2 outlier
            # classification so this path culls exactly like the
            # single-device one (Optimizer.cc LocalBA post-pass).
            from fasttrack_tpu.optim.local_ba import BAResult
            from fasttrack_tpu.parallel.dist_ba import (
                distributed_bundle_adjustment,
            )

            poses, points, _, inlier, chi2 = distributed_bundle_adjustment(
                prob, self.camera, self.bf, self.mesh, iters=8
            )
            res = BAResult(poses, points, inlier, chi2)
            write_back(m, meta, res, drop_outliers=True)
        else:
            res = solve(prob, self.camera, jnp.float32(self.bf))
            write_back(m, meta, res)

    # ------------------------------------------------------- inertial backend
    def _temporal_chain(self, kf: KeyFrame, max_len: int = 64):
        """Walk prev_kf_id links back from ``kf`` (oldest first)."""
        m = self.atlas.current
        chain = [kf]
        cur = kf
        while cur.prev_kf_id is not None and len(chain) < max_len:
            prev = m.keyframes.get(cur.prev_kf_id)
            if prev is None:
                break
            chain.append(prev)
            cur = prev
        chain.reverse()
        return chain

    def _try_initialize_imu(self, kf: KeyFrame, min_span_s: float = 2.0):
        """LocalMapping::InitializeIMU (LocalMapping.cc:1173): once enough
        keyframes with preintegration exist, estimate gyro bias, gravity,
        velocities (and scale for monocular) in closed form
        (imu.init.initialize_imu replaces InertialOptimization,
        Optimizer.cc:3042), align the map gravity to -z via
        ApplyScaledRotation, and hand the state back to the tracker."""
        from fasttrack_tpu.imu.init import initialize_imu

        m = self.atlas.current
        chain = self._temporal_chain(kf)
        chain = [k for k in chain if k.kid == chain[0].kid or k.preintegrated is not None]
        if len(chain) < self.imu_init_kfs:
            return
        if chain[-1].timestamp - chain[0].timestamp < min_span_s:
            return
        R_bc = np.asarray(self.imu_calib.R_bc, np.float64)
        t_bc = np.asarray(self.imu_calib.t_bc, np.float64)
        R_wb, p_w, preints = [], [], []
        for i, k in enumerate(chain):
            Rb, pb = _body_from_cam_np(k.R_cw, k.t_cw, R_bc, t_bc)
            R_wb.append(Rb)
            p_w.append(pb)
            if i > 0:
                preints.append(k.preintegrated)
        # First init: acc bias pinned to zero (the reference's priorA=1e10
        # first InitializeIMU call, LocalMapping.cc:181) — over a 2 s window
        # ba is degenerate with the gravity direction; the VIBA-stage
        # refits (prior_a 1.0 -> 0.1) release it once motion accumulates.
        res = initialize_imu(R_wb, p_w, preints, mono_scale=self.monocular,
                             estimate_ba=False)
        if not res.success:
            return
        # Align gravity (and scale): world' = s * R_gw * world.
        scale = res.scale if self.monocular else 1.0
        m.apply_scaled_rotation(res.R_gw, scale)
        for i, k in enumerate(chain):
            k.velocity = scale * (res.R_gw @ res.velocities[i])
            k.imu_bias = (res.bg.copy(), res.ba.copy())
        m.imu_initialized = True
        self.imu_init_time = kf.timestamp
        m.info_changed()
        if self.tracker is not None and chain[-1].kid == getattr(
            self.tracker, "last_kf_id", None
        ):
            t = self.tracker
            t.bias = (res.bg.copy(), res.ba.copy())
            last = chain[-1]
            R_wb_l, p_w_l = _body_from_cam_np(last.R_cw, last.t_cw, R_bc, t_bc)
            t.last_kf_state = (R_wb_l, p_w_l, np.asarray(last.velocity))
            t.v_w = np.asarray(last.velocity)
            # The running since-KF preintegration is kept: its bias
            # linearization point is corrected via the stored Jacobians.
        # VIBA: polish the freshly initialized window with a full inertial BA
        # (the reference's FullInertialBA after init, LocalMapping.cc:181-242).
        self._local_inertial_ba(kf)

    def _scale_refinement(self, kf: KeyFrame):
        """LocalMapping::ScaleRefinement (LocalMapping.cc:1429): re-estimate
        the monocular map scale (and gravity direction) in closed form over
        the recent temporal chain; apply only when the correction is
        non-trivial (|s - 1| > 0.002, the reference's gate)."""
        from fasttrack_tpu.imu.init import initialize_imu

        m = self.atlas.current
        chain = self._temporal_chain(kf, max_len=64)
        chain = [k for i, k in enumerate(chain)
                 if i == 0 or k.preintegrated is not None]
        if len(chain) < self.imu_init_kfs:
            return
        R_bc = np.asarray(self.imu_calib.R_bc, np.float64)
        t_bc = np.asarray(self.imu_calib.t_bc, np.float64)
        R_wb, p_w, preints = [], [], []
        for i, k in enumerate(chain):
            Rb, pb = _body_from_cam_np(k.R_cw, k.t_cw, R_bc, t_bc)
            R_wb.append(Rb)
            p_w.append(pb)
            if i > 0:
                preints.append(k.preintegrated)
        res = initialize_imu(R_wb, p_w, preints, mono_scale=True)
        if not res.success:
            return
        if abs(res.scale - 1.0) > 0.002:
            m.apply_scaled_rotation(res.R_gw, res.scale, scale_velocities=True)
            if self.tracker is not None and chain[-1].kid == getattr(
                self.tracker, "last_kf_id", None
            ):
                t = self.tracker
                last = chain[-1]
                R_wb_l, p_w_l = _body_from_cam_np(last.R_cw, last.t_cw, R_bc, t_bc)
                v = np.asarray(last.velocity) if last.velocity is not None else t.v_w
                t.last_kf_state = (R_wb_l, p_w_l, v)
            m.info_changed()

    def _local_inertial_ba(self, kf: KeyFrame, window: int = 8):
        """Optimizer::LocalInertialBA (Optimizer.cc:2383): temporal window of
        recent KFs with per-KF (pose, velocity, bias) states, inertial edges
        between consecutive KFs, visual edges to the window's map points,
        and FIXED out-of-window anchor KFs observing those points (the
        reference's lFixedKeyFrames, Optimizer.cc:2446-2475). Without the
        anchors the window is tied to the rest of the map only through the
        single gauge KF, and every LIBA call can warp the recent map
        consistently with a window-wide pose/bias shift — measured as a
        steady ~1-sigma-per-frame accelerometer-bias drift that eventually
        collapses tracking on revisit trajectories."""
        chain = self._temporal_chain(kf, max_len=window + 1)
        self._inertial_window_ba(chain, window, n_anchors=4)

    def _full_inertial_ba(self, kf: KeyFrame, window: int = 8,
                          should_abort=None, lock=None):
        """Optimizer::FullInertialBA (Optimizer.cc:392), staged from
        LocalMapping.cc:181-242: polish the WHOLE temporal chain after IMU
        initialization. Fixed-shape design: overlapping fixed-shape inertial
        windows swept along the chain (each window anchors on the previous
        window's last optimized state), like the visual global BA's block
        sweeps — one XLA program regardless of map size."""
        import contextlib

        hold = (lambda: lock) if lock is not None else (
            lambda: contextlib.nullcontext()
        )
        with hold():
            chain = self._temporal_chain(kf, max_len=100000)
        if len(chain) <= window + 1:
            with hold():
                self._inertial_window_ba(chain, window)
            return
        step = max(window - 1, 1)
        for start in range(0, len(chain) - 2, step):
            if should_abort is not None and should_abort():
                return
            seg = chain[start:start + window + 1]
            if len(seg) >= 3:
                with hold():
                    self._inertial_window_ba(seg, window)

    def full_inertial_ba_converged(self, kf: KeyFrame, window: int = 8,
                                   max_rounds: int = 4, tol: float = 1e-4,
                                   should_abort=None, lock=None) -> int:
        """Iterate the forward window sweep until the chain stops moving —
        the swept approximation of the reference's single JOINT FullInertialBA
        solve (Optimizer.cc:392): one forward pass only propagates the loop
        correction a window at a time, so repeat until the max pose delta
        across the chain falls under ``tol`` (or ``max_rounds``). Used as the
        inertial branch of the post-loop global BA (LoopClosing.cc:2275-2280).
        Returns the number of sweep rounds run."""
        rounds = 0
        for _ in range(max_rounds):
            if should_abort is not None and should_abort():
                break
            chain = self._temporal_chain(kf, max_len=100000)
            before = {k.kid: (k.R_cw.copy(), k.t_cw.copy()) for k in chain}
            self._full_inertial_ba(
                kf, window, should_abort=should_abort, lock=lock
            )
            rounds += 1
            delta = 0.0
            for k in chain:
                R0, t0 = before[k.kid]
                delta = max(
                    delta,
                    float(np.abs(k.t_cw - t0).max()),
                    float(np.abs(k.R_cw - R0).max()),
                )
            if delta < tol:
                break
        return rounds

    def _inertial_window_ba(self, chain, window: int = 8,
                            n_anchors: int = 0):
        import jax.numpy as jnp

        from fasttrack_tpu.imu.preintegration import ImuBias, Preintegrated
        from fasttrack_tpu.optim.inertial import (
            BodyState, InertialBAProblem, local_inertial_ba,
        )

        m = self.atlas.current
        # need contiguous preintegration between all consecutive pairs
        usable = [chain[0]]
        for k in chain[1:]:
            if k.preintegrated is None:
                usable = [k]
            else:
                usable.append(k)
        chain = usable
        if len(chain) < 3:
            return
        # Fixed window size: ONE XLA compile regardless of how many KFs the
        # temporal chain actually has (front-padded with the oldest state,
        # masked out via state_free / pre_valid). ``n_anchors`` extra padded
        # slots at the front hold FIXED out-of-window anchor KFs with visual
        # observations only — no inertial edges reach the padding, so the
        # anchor slots reuse the padding machinery as-is.
        K = n_anchors + window + 1
        chain = chain[-(window + 1):]
        n_real = len(chain)
        pad = K - n_real
        R_bc = np.asarray(self.imu_calib.R_bc, np.float64)
        t_bc = np.asarray(self.imu_calib.t_bc, np.float64)

        R_wb = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        p_w = np.zeros((K, 3), np.float32)
        v_w = np.zeros((K, 3), np.float32)
        bg = np.zeros((K, 3), np.float32)
        ba = np.zeros((K, 3), np.float32)
        for i, k in enumerate(chain):
            Rb, pb = _body_from_cam_np(k.R_cw, k.t_cw, R_bc, t_bc)
            R_wb[pad + i] = Rb
            p_w[pad + i] = pb
            v_w[pad + i] = k.velocity if k.velocity is not None else 0.0
            if k.imu_bias is not None:
                bg[pad + i], ba[pad + i] = k.imu_bias
        # padding + oldest real KF fixed (gauge); all others free
        state_free = np.ones(K, bool)
        state_free[:pad + 1] = False

        def stack_pre():
            eye = np.eye(3, dtype=np.float32)
            def field(name, default):
                vals = [default] * pad
                for i in range(n_real - 1):
                    vals.append(np.asarray(
                        getattr(chain[i + 1].preintegrated, name), np.float32))
                return jnp.asarray(np.stack(vals))

            dT = jnp.asarray(
                np.asarray([0.0] * pad + [chain[i + 1].preintegrated.dT
                                          for i in range(n_real - 1)], np.float32)
            )
            zero33 = np.zeros((3, 3), np.float32)
            b0 = ImuBias(
                jnp.asarray(np.stack([np.zeros(3, np.float32)] * pad + [
                    np.asarray(chain[i + 1].preintegrated.b0.bg, np.float32)
                    for i in range(n_real - 1)
                ])),
                jnp.asarray(np.stack([np.zeros(3, np.float32)] * pad + [
                    np.asarray(chain[i + 1].preintegrated.b0.ba, np.float32)
                    for i in range(n_real - 1)
                ])),
            )
            zero3 = jnp.zeros((K - 1, 3), jnp.float32)
            return Preintegrated(
                dT, field("dR", eye), field("dV", np.zeros(3, np.float32)),
                field("dP", np.zeros(3, np.float32)),
                field("JRg", zero33), field("JVg", zero33), field("JVa", zero33),
                field("JPg", zero33), field("JPa", zero33),
                field("C", np.eye(15, dtype=np.float32) * 1e-6),
                b0, zero3, zero3,
            )

        pre = stack_pre()
        pre_valid = np.zeros(K - 1, bool)
        pre_valid[pad:] = True

        # Visual observations over the window (same packing as _local_ba,
        # smaller point cap: the temporal window is narrower).
        L = 1024
        kf_index = {k.kid: pad + j for j, k in enumerate(chain)}
        mp_ids = []
        seen = set()
        dropped = 0
        for k in chain:
            for mid in k.mp_ids:
                if mid >= 0 and int(mid) not in seen:
                    mp = m.mappoints.get(int(mid))
                    if mp is not None and not mp.bad:
                        seen.add(int(mid))
                        if len(mp_ids) < L:
                            mp_ids.append(int(mid))
                        else:
                            dropped += 1
        if dropped:
            import logging

            logging.getLogger(__name__).info(
                "local_inertial_ba: window overflow, dropped %d points (cap %d)",
                dropped, L,
            )

        if n_anchors > 0:
            # Fixed frontier (Optimizer.cc:2446-2475 lFixedKeyFrames): the
            # out-of-window KFs observing the most window points occupy the
            # first padded slots — visual edges only, state_free False.
            chain_ids = {k.kid for k in chain}
            votes: dict[int, int] = {}
            for mid in mp_ids:
                for kid in m.mappoints[mid].observations:
                    if kid not in chain_ids and kid in m.keyframes:
                        votes[kid] = votes.get(kid, 0) + 1
            top = sorted(votes, key=lambda k: -votes[k])[:min(n_anchors, pad)]
            for j, kid in enumerate(top):
                ak = m.keyframes[kid]
                Rb, pb = _body_from_cam_np(ak.R_cw, ak.t_cw, R_bc, t_bc)
                R_wb[j] = Rb
                p_w[j] = pb
                kf_index[kid] = j

        pts = np.zeros((L, 3), np.float32)
        pt_free = np.zeros(L, bool)
        obs_uv = np.zeros((L, K, 2), np.float32)
        obs_ur = np.full((L, K), -1.0, np.float32)
        inv_s2 = np.ones((L, K), np.float32)
        mask = np.zeros((L, K), bool)
        for li, mid in enumerate(mp_ids):
            mp = m.mappoints[mid]
            pts[li] = mp.position
            pt_free[li] = True
            for kid, fi in mp.observations.items():
                j = kf_index.get(kid)
                if j is None:
                    continue
                kkf = m.keyframes[kid]
                if fi >= len(kkf.kp_uv) or not kkf.valid[fi]:
                    continue
                obs_uv[li, j] = kkf.kp_uv[fi]
                obs_ur[li, j] = kkf.u_right[fi]
                inv_s2[li, j] = self.inv_sigma2[kkf.kp_level[fi]]
                mask[li, j] = True

        prob = InertialBAProblem(
            states=BodyState(
                jnp.asarray(R_wb), jnp.asarray(p_w), jnp.asarray(v_w),
                jnp.asarray(bg), jnp.asarray(ba),
            ),
            state_free=jnp.asarray(state_free),
            pre=pre,
            pre_valid=jnp.asarray(pre_valid),
            points=jnp.asarray(pts),
            point_free=jnp.asarray(pt_free),
            obs_uv=jnp.asarray(obs_uv),
            obs_ur=jnp.asarray(obs_ur),
            inv_sigma2=jnp.asarray(inv_s2),
            mask=jnp.asarray(mask),
        )
        res = local_inertial_ba(
            prob, self.camera, jnp.float32(self.bf),
            jnp.asarray(R_bc, jnp.float32), jnp.asarray(t_bc, jnp.float32),
        )

        from fasttrack_tpu.nputils import orthonormalize

        R_new = np.asarray(res.states.R_wb, np.float64)
        p_new = np.asarray(res.states.p_w, np.float64)
        v_new = np.asarray(res.states.v_w, np.float64)
        bg_new = np.asarray(res.states.bg, np.float64)
        ba_new = np.asarray(res.states.ba, np.float64)
        pts_new = np.asarray(res.points, np.float64)
        R_cb = R_bc.T
        t_cb = -R_cb @ t_bc
        for i, k in enumerate(chain):
            j = pad + i
            if not state_free[j]:
                continue
            if not (np.isfinite(R_new[j]).all() and np.isfinite(p_new[j]).all()):
                continue
            Rwb = orthonormalize(R_new[j])
            R_cw = R_cb @ Rwb.T
            t_cw = t_cb - R_cw @ p_new[j]
            k.set_pose(R_cw, t_cw)
            if np.isfinite(v_new[j]).all():
                k.velocity = v_new[j]
            k.imu_bias = (bg_new[j], ba_new[j])
        for li, mid in enumerate(mp_ids):
            mp = m.mappoints.get(mid)
            if mp is not None and np.isfinite(pts_new[li]).all():
                mp.position = pts_new[li]
        # refresh the tracker's anchor if we moved its reference KF
        if self.tracker is not None and chain[-1].kid == getattr(
            self.tracker, "last_kf_id", None
        ):
            t = self.tracker
            last = chain[-1]
            R_wb_l, p_w_l = _body_from_cam_np(last.R_cw, last.t_cw, R_bc, t_bc)
            t.last_kf_state = (R_wb_l, p_w_l, np.asarray(last.velocity))
            if last.imu_bias is not None:
                t.bias = (np.asarray(last.imu_bias[0]),
                          np.asarray(last.imu_bias[1]))
        m.info_changed()

    def _cull_keyframes(self, kf: KeyFrame):
        """KeyFrameCulling (LocalMapping.cc:902): erase local KFs whose map
        points are >=90% observed by >=3 other KFs at same/finer scale.

        Inertial mode (LocalMapping.cc:935-1007): the temporal prev/next
        chain carries the preintegration constraints, so culling is
        suppressed until the IMU is initialized, and afterwards a KF is only
        erased when its removal keeps the chain dense (gap < 3 s) — its
        preintegration is merged into the next KF (ImuTypes::MergePrevious)."""
        m = self.atlas.current
        if self.imu_calib is not None and not m.imu_initialized:
            return
        for kid in kf.best_covisible(10):
            other = m.keyframes.get(kid)
            if other is None or other.kid == m.init_kf_id:
                continue
            if self.imu_calib is not None:
                prev = m.keyframes.get(other.prev_kf_id) if other.prev_kf_id else None
                nxt = m.keyframes.get(other.next_kf_id) if other.next_kf_id else None
                if prev is None or nxt is None:
                    continue
                if nxt.timestamp - prev.timestamp > 3.0:
                    continue
            total = 0
            redundant = 0
            for fi, mid in enumerate(other.mp_ids):
                if mid < 0:
                    continue
                mp = m.mappoints.get(int(mid))
                if mp is None or mp.bad:
                    continue
                total += 1
                level = int(other.kp_level[fi])
                n_better = 0
                for okid, ofi in mp.observations.items():
                    if okid == other.kid:
                        continue
                    okf = m.keyframes.get(okid)
                    if okf is None:
                        continue
                    if int(okf.kp_level[ofi]) <= level + 1:
                        n_better += 1
                        if n_better >= 3:
                            break
                if n_better >= 3:
                    redundant += 1
            if total > 20 and redundant > 0.9 * total:
                if self.imu_calib is not None:
                    prev = m.keyframes.get(other.prev_kf_id)
                    nxt = m.keyframes.get(other.next_kf_id)
                    if prev is not None and nxt is not None:
                        if other.preintegrated is not None and nxt.preintegrated is not None:
                            nxt.preintegrated = _merge_preintegrated(
                                other.preintegrated, nxt.preintegrated
                            )
                        prev.next_kf_id = nxt.kid
                        nxt.prev_kf_id = prev.kid
                m.erase_keyframe(other.kid)


def fuse_mappoints_into(m, tkf, mids, camera, scale_factor: float,
                        n_levels: int, th: float = 3.0) -> int:
    """ORBmatcher::Fuse (ORBmatcher.cc:1247): project map points into
    ``tkf``, window-search a matching keypoint under TH_LOW, then either
    merge with the keypoint's bound point (keep the better-observed one,
    MapPoint::Replace) or add a new observation. Shared by
    LocalMapping::SearchInNeighbors (LocalMapping.cc:714) and the loop
    closer's SearchAndFuse (LoopClosing.cc:2115)."""
    from fasttrack_tpu.cameras.host import (
        frustum_depth_ok, in_image_np, project_np,
    )
    from fasttrack_tpu.ops.host_kernels import host_search_by_projection

    if not mids:
        return 0
    mps = []
    for mid in mids:
        mp = m.mappoints.get(int(mid))
        if (
            mp is not None and not mp.bad and mp.desc_packed is not None
            and tkf.kid not in mp.observations
        ):
            mps.append(mp)
    if not mps:
        return 0
    pos = np.asarray([mp.position for mp in mps])
    Xc = pos @ tkf.R_cw.T + tkf.t_cw
    uv = project_np(camera, Xc)
    dist = np.linalg.norm(Xc, axis=1)
    normals = np.asarray([mp.normal for mp in mps])
    view = pos - tkf.center
    view_n = view / np.maximum(np.linalg.norm(view, axis=1, keepdims=True), 1e-9)
    min_d = np.asarray([0.8 * mp.min_distance for mp in mps])
    max_d = np.asarray([1.2 * mp.max_distance for mp in mps])
    ok = (
        frustum_depth_ok(camera, Xc)
        & in_image_np(camera, uv)
        & (dist >= min_d) & (dist <= max_d)
        & (np.sum(normals * view_n, axis=1) > 0.5)
    )
    if not ok.any():
        return 0
    levels = np.asarray([
        mp.predict_scale(float(d), scale_factor, n_levels)
        for mp, d in zip(mps, dist)
    ], np.int32)
    radius = (th * scale_factor**levels).astype(np.float32)
    q_packed = np.asarray([mp.desc_packed for mp in mps])
    idx, _, hit = host_search_by_projection(
        uv.astype(np.float32), q_packed, radius,
        np.maximum(levels - 1, 0), np.minimum(levels + 1, n_levels - 1),
        ok, tkf.kp_uv.astype(np.float32), tkf.desc_packed,
        tkf.kp_level.astype(np.int32), tkf.valid,
        max_dist=50,  # TH_LOW: fusion requires a strong match
    )
    n_fused = 0
    for q in np.where(hit)[0]:
        mp = mps[q]
        if mp.bad:
            continue
        i = int(idx[q])
        cur = int(tkf.mp_ids[i])
        if cur >= 0:
            other = m.mappoints.get(cur)
            if other is None or other.bad or other.mid == mp.mid:
                continue
            # keep the better-observed point (ORBmatcher.cc:1330-1338)
            if other.n_obs() >= mp.n_obs():
                m.replace_mappoint(mp.mid, other.mid)
            else:
                m.replace_mappoint(other.mid, mp.mid)
        else:
            mp.add_observation(tkf.kid, i)
            tkf.mp_ids[i] = mp.mid
        n_fused += 1
    return n_fused
