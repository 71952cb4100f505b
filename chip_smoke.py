#!/usr/bin/env python3
"""Smoke run of the SLAM main path on a GPU: the quickest proof that the
system still starts and tracks on the card.

    python chip_smoke.py                # one GPU: phases 1-5
    python chip_smoke.py --four-cards   # four GPUs of one host: the
                                        # multi-device path only

One GPU, at the EuRoC stereo(-inertial) rig's widths (752x480,
OrbConfig(n_features=1024, n_levels=8), 20 Hz camera, 200 Hz IMU):

1. device      the default JAX device must be a GPU; prints the card.
2. parity      the same jitted kernels on the GPU and on the CPU: the
               Hamming matrix bit-exact, extraction + stereo matching
               within stated tolerances.
3. hot path    frame_pipeline.tracking_hot_path on ~20 fresh frames, match
               sets compared with the CPU run.
4. stereo      System(Sensor.STEREO) with local mapping and loop closing on
               a rendered loop sequence; ATE against ground truth.
5. inertial    System(Sensor.IMU_STEREO) on the same frames with 200 Hz IMU;
               the IMU must initialise.

With --four-cards: distributed bundle adjustment on a 4-GPU mesh against
the one-GPU solve of the same window, and sharded extraction of 4 frames
against per-frame extraction.

Every phase prints one line with its wall seconds and result, tagged with
the card's name and power limit. Timings are smoke readings, not
benchmarks. The last line of stdout is one JSON object,
{"ok": true, "device": {...}}, printed only when every phase passed; the
exit code is non-zero otherwise, and when no GPU is found.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

H, W = 480, 752
N_FEATURES, N_LEVELS = 1024, 8
N_MAP = 2048             # bench.py's local-map size for search-by-projection
HOT_PATH_FRAMES = 20
SYSTEM_FRAMES = 400      # two laps of the loop trajectory at 20 Hz
# IMU initialisation needs ~2 s of keyframes; past ~8 s the inertial
# estimator drifts on this sequence (ROADMAP, Reach), so the inertial phase
# stops at 7.5 s.
INERTIAL_FRAMES = 150

# Tolerances for GPU-vs-CPU parity. Extraction thresholds FAST scores and
# compares BRIEF sample pairs, so last-bit differences in the pyramid (sums
# taken in another order) can flip a borderline keypoint or bit:
KP_OVERLAP_MIN = 0.97    # share of keypoints (x, y, level) found on both
DESC_BITS_MAX = 4.0      # mean differing bits of co-detected descriptors
DEPTH_DIFF_MAX_M = 0.05  # median |depth difference| of co-matched keypoints
MATCH_AGREE_MIN = 0.95   # share of hot-path queries with the same match
ATE_MAX_M = 0.10         # the example drivers' ATE gate (tests/test_drivers.py)
TRACKED_MIN = 0.95       # share of frames that end in the OK state

PRECISION_NOTE = (
    "precision: Hamming int8 x int8 -> int32 (exact on both); stereo pyramid "
    "pair f32 at HIGHEST (full FP32 on both); single-image pyramid "
    "Precision.DEFAULT (TF32 on the GPU, FP32 on the CPU); BRIEF sampling "
    "bf16 operands with f32 sums on both; geometry f32 at HIGHEST"
)


class Compiles:
    """Seconds JAX spent tracing, lowering and compiling, from its
    monitoring events."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration


def keep_cpu_platform():
    """Keep the CPU available beside the GPU for the parity phases (the GPU
    stays the default device). Call before JAX is imported."""
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"


def require_gpu(devices, count: int = 1):
    """Raise RuntimeError unless `devices` starts with `count` GPUs."""
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "none"
        raise RuntimeError(f"no GPU: JAX's default device is {kind}")
    gpus = [d for d in devices if d.platform == "gpu"]
    if len(gpus) < count:
        raise RuntimeError(f"need {count} GPUs, found {len(gpus)}")
    return gpus[:count]


def card_names() -> list[str]:
    """`name, power.limit` of each card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


# ------------------------------------------------------------- comparisons
def _kp_key(r, i):
    return (int(round(2 * r["x"][i])), int(round(2 * r["y"][i])),
            int(r["level"][i]))


def compare_keypoints(a: dict, b: dict) -> dict:
    """Set-based comparison of two extractions (slot order may differ
    between backends through top-k tie-breaking): keypoint overlap, bit
    differences of co-detected descriptors, and the index pairs."""
    ka = {_kp_key(a, i): i for i in np.flatnonzero(a["valid"])}
    kb = {_kp_key(b, i): i for i in np.flatnonzero(b["valid"])}
    common = ka.keys() & kb.keys()
    ia = np.asarray([ka[k] for k in common], np.int64)
    ib = np.asarray([kb[k] for k in common], np.int64)
    bits = np.unpackbits(a["desc"][ia] ^ b["desc"][ib], axis=1).sum(1)
    return {
        "overlap": len(common) / max(min(len(ka), len(kb)), 1),
        "desc_bits": float(bits.mean()) if len(bits) else float("inf"),
        "ia": ia, "ib": ib,
    }


def _keypoints_host(kps) -> dict:
    return {
        "x": np.asarray(kps.x), "y": np.asarray(kps.y),
        "level": np.asarray(kps.level), "valid": np.asarray(kps.valid),
        "desc": np.asarray(kps.desc_packed),
    }


# ------------------------------------------------------------------ phases
def phase_parity(gpu, cpu):
    """Phase 2: the same jitted functions on the GPU and on the CPU."""
    import jax
    import jax.numpy as jnp

    from fasttrack_tpu.datasets.synthetic import _render, make_texture
    from fasttrack_tpu.frame_pipeline import _stereo_match_stage
    from fasttrack_tpu.ops import OrbConfig
    from fasttrack_tpu.ops.extractor import extract_orb_pair_stacked
    from fasttrack_tpu.ops.hamming import hamming_matrix, hamming_matrix_f32

    rng = np.random.default_rng(7)
    s1 = (2 * rng.integers(0, 2, (1024, 256)) - 1).astype(np.int8)
    s2 = (2 * rng.integers(0, 2, (2048, 256)) - 1).astype(np.int8)
    ham = {}
    for dev in (gpu, cpu):
        a, b = jax.device_put(s1, dev), jax.device_put(s2, dev)
        ham[dev.platform] = (np.asarray(jax.jit(hamming_matrix)(a, b)),
                             np.asarray(jax.jit(hamming_matrix_f32)(a, b)))
    ham_exact = all(np.array_equal(g, c)
                    for g, c in zip(ham[gpu.platform], ham[cpu.platform]))

    # One rendered stereo pair: plane at 5 m, 0.3 m baseline, f = 400 px.
    cfg = OrbConfig(height=H, width=W, n_features=N_FEATURES, n_levels=N_LEVELS)
    tex = make_texture(np.random.default_rng(42), size=1024)
    K = np.array([[400.0, 0, W / 2], [0, 400.0, H / 2], [0, 0, 1.0]])
    left = _render(tex, 170.0, K, np.eye(3), np.zeros(3), H, W, 5.0)
    right = _render(tex, 170.0, K, np.eye(3), np.array([0.3, 0, 0]), H, W, 5.0)
    stacked = np.stack([left, right]).astype(np.uint8)

    res = {}
    for dev in (gpu, cpu):
        with jax.default_device(dev):
            kl, kr, pl, pr = extract_orb_pair_stacked(
                jax.device_put(stacked, dev), cfg)
            sm, _ = _stereo_match_stage(
                kl, kr, pl.raw, pr.raw, cfg,
                jnp.float32(0.3 * 400.0), jnp.float32(0.3),
            )
            r = _keypoints_host(kl)
            r["depth"] = np.asarray(sm.depth)
            r["sm_valid"] = np.asarray(sm.valid)
            res[dev.platform] = r
    g, c = res[gpu.platform], res[cpu.platform]
    cmp = compare_keypoints(g, c)
    both = g["sm_valid"][cmp["ia"]] & c["sm_valid"][cmp["ib"]]
    dd = np.abs(g["depth"][cmp["ia"]][both] - c["depth"][cmp["ib"]][both])
    depth_med = float(np.median(dd)) if len(dd) else float("inf")
    ok = (ham_exact and cmp["overlap"] >= KP_OVERLAP_MIN
          and cmp["desc_bits"] <= DESC_BITS_MAX and depth_med <= DEPTH_DIFF_MAX_M)
    return ok, {
        "hamming_1024x2048_bit_exact": ham_exact,
        "n_kp_gpu": int(g["valid"].sum()), "n_kp_cpu": int(c["valid"].sum()),
        "kp_overlap": round(cmp["overlap"], 4),
        "desc_mean_bits_diff": round(cmp["desc_bits"], 3),
        "n_stereo_gpu": int(g["sm_valid"].sum()),
        "n_stereo_cpu": int(c["sm_valid"].sum()),
        "depth_median_diff_m": depth_med,
    }


def _hot_path_inputs(n_frames: int, n_map: int, h: int = H, w: int = W):
    """Rendered frames, a local map built from frame 0's stereo points
    (padded with random clutter to `n_map` rows), and per frame the map
    projected through the true pose plus a perturbed initial pose."""
    import jax.numpy as jnp

    from fasttrack_tpu.datasets.synthetic import generate_sequence
    from fasttrack_tpu.frame_pipeline import process_stereo_frame_stacked
    from fasttrack_tpu.ops import OrbConfig

    seq = generate_sequence(n_frames=n_frames + 1, h=h, w=w, seed=1)
    cfg = OrbConfig(height=h, width=w, n_features=N_FEATURES, n_levels=N_LEVELS)
    bf = seq.fx * seq.baseline
    stacks = [np.stack([f.left, f.right]).clip(0, 255).astype(np.uint8)
              for f in seq.frames]
    fd = process_stereo_frame_stacked(
        jnp.asarray(stacks[0]), cfg, jnp.float32(bf), jnp.float32(seq.baseline))
    depth = np.asarray(fd.depth)
    keep = np.flatnonzero(np.asarray(fd.kps.valid) & (depth > 0))[:n_map]
    u, v, z = np.asarray(fd.kps.x)[keep], np.asarray(fd.kps.y)[keep], depth[keep]
    Xc = np.stack([(u - seq.cx) / seq.fx * z, (v - seq.cy) / seq.fy * z, z], -1)
    f0 = seq.frames[0]
    rng = np.random.default_rng(2)
    n_pad = n_map - len(keep)
    Xw = np.concatenate([
        Xc @ f0.R_wc.T + f0.t_wc,
        np.stack([rng.uniform(-4, 4, n_pad), rng.uniform(-3, 3, n_pad),
                  rng.uniform(2, 6, n_pad)], -1),
    ]).astype(np.float32)
    desc = np.concatenate([
        np.asarray(fd.kps.desc_signed)[keep],
        (2 * rng.integers(0, 2, (n_pad, 256)) - 1).astype(np.int8),
    ])
    lvl = np.concatenate([np.asarray(fd.kps.level)[keep],
                          np.zeros(n_pad, np.int32)]).astype(np.int32)
    per_frame = []
    for f in seq.frames[1:]:
        R_cw = f.R_wc.T
        t_cw = -R_cw @ f.t_wc
        Xcf = Xw @ R_cw.T + t_cw
        zf = np.maximum(Xcf[:, 2], 1e-3)
        per_frame.append({
            "map_u": (seq.fx * Xcf[:, 0] / zf + seq.cx).astype(np.float32),
            "map_v": (seq.fy * Xcf[:, 1] / zf + seq.cy).astype(np.float32),
            "R0": R_cw.astype(np.float32),
            "t0": (t_cw + np.array([0.02, -0.01, 0.01])).astype(np.float32),
            "t_true": t_cw,
        })
    common = {
        "map_desc": desc, "map_pos": Xw,
        "map_radius": np.full(n_map, 8.0, np.float32),
        "map_lmin": np.maximum(lvl - 1, 0), "map_lmax": lvl + 1,
        "map_ok": np.ones(n_map, bool),
    }
    return seq, cfg, stacks[1:], per_frame, common


def run_hot_path(device, seq, cfg, stacks, per_frame, common):
    """tracking_hot_path on `device` for every frame; per-frame wall ms
    (image upload to pose on the host) and host copies of the results."""
    import jax
    import jax.numpy as jnp

    from fasttrack_tpu.cameras import make_pinhole
    from fasttrack_tpu.frame_pipeline import tracking_hot_path
    from fasttrack_tpu.geometry import SE3

    with jax.default_device(device):
        cam = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, cfg.width, cfg.height)
        bf = jnp.float32(seq.fx * seq.baseline)
        min_z = jnp.float32(seq.baseline)
        shared = {k: jax.device_put(v, device) for k, v in common.items()}
        staged = [{k: jax.device_put(v, device) for k, v in p.items()
                   if k != "t_true"} for p in per_frame]
        times, outs = [], []
        for img, p in zip(stacks, staged):
            t0 = time.perf_counter()
            fd, res, opt = tracking_hot_path(
                jnp.asarray(img), cfg, bf, min_z, cam, SE3(p["R0"], p["t0"]),
                p["map_u"], p["map_v"], shared["map_desc"], shared["map_pos"],
                shared["map_radius"], shared["map_lmin"], shared["map_lmax"],
                shared["map_ok"],
            )
            jax.block_until_ready((res, opt))
            times.append((time.perf_counter() - t0) * 1e3)
            outs.append((fd, res, opt))
        host = []
        for fd, res, opt in outs:
            r = _keypoints_host(fd.kps)
            r.update(idx=np.asarray(res.idx), ok=np.asarray(res.ok),
                     t=np.asarray(opt.pose.t), R=np.asarray(opt.pose.R),
                     n_valid=int(fd.n_valid))
            host.append(r)
    return times, host


def compare_matches(g: dict, c: dict) -> tuple[int, int]:
    """Queries whose match agrees between two runs (both unmatched, or both
    matched to the same keypoint by position and level), and the total."""
    agree = 0
    for q in range(len(g["ok"])):
        if g["ok"][q] != c["ok"][q]:
            continue
        if not g["ok"][q] or _kp_key(g, g["idx"][q]) == _kp_key(c, c["idx"][q]):
            agree += 1
    return agree, len(g["ok"])


def phase_hot_path(gpu, cpu, n_frames=HOT_PATH_FRAMES, n_map=N_MAP, h=H, w=W):
    """Phase 3: the three-program tracking hot path, GPU against CPU."""
    seq, cfg, stacks, per_frame, common = _hot_path_inputs(n_frames, n_map, h, w)
    times, g = run_hot_path(gpu, seq, cfg, stacks, per_frame, common)
    _, c = run_hot_path(cpu, seq, cfg, stacks, per_frame, common)
    agree = total = 0
    for gf, cf in zip(g, c):
        a, t = compare_matches(gf, cf)
        agree, total = agree + a, total + t
    finite = all(np.isfinite(r["t"]).all() and np.isfinite(r["R"]).all() for r in g)
    n_valid = min(r["n_valid"] for r in g)
    n_matched = int(np.median([r["ok"].sum() for r in g]))
    pose_err = [float(np.linalg.norm(r["t"] - p["t_true"]))
                for r, p in zip(g, per_frame)]
    ok = finite and n_valid > 0 and n_matched > 0 and agree / total >= MATCH_AGREE_MIN
    return ok, {
        "frames": len(times),
        "first_call_s": round(times[0] / 1e3, 3),
        "smoke_median_ms_per_frame": float(np.median(times[1:])),
        "poses_finite": finite, "min_n_valid": n_valid,
        "median_matches": n_matched,
        "match_agreement": round(agree / total, 4),
        "median_pose_err_m": float(np.median(pose_err)),
    }


def _system_settings(seq, h: int, w: int, inertial: bool):
    from fasttrack_tpu.cameras import make_pinhole
    from fasttrack_tpu.settings import Settings

    s = Settings()
    s.width, s.height = w, h
    s.camera1 = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, w, h)
    s.bf = seq.fx * seq.baseline
    s.baseline = seq.baseline
    s.th_depth = 60.0
    s.n_features, s.n_levels = N_FEATURES, N_LEVELS
    if inertial:
        s.T_b_c1 = np.eye(4)   # the renderer's body frame is cam0
        s.imu_frequency = 200.0
    return s


def run_system(seq, n_frames: int, inertial: bool, h: int = H, w: int = W):
    """Track the first `n_frames` of `seq` through the full System; returns
    the System and per-frame (wall ms, device fetches, tracking OK, IMU
    initialised)."""
    from fasttrack_tpu.system import Sensor, System
    from fasttrack_tpu.tracking import TrackingState

    system = System(_system_settings(seq, h, w, inertial),
                    Sensor.IMU_STEREO if inertial else Sensor.STEREO)
    series = system.stats.series
    rows, t_prev = [], -1.0
    for fr in seq.frames[:n_frames]:
        imu = None
        if inertial:
            sel = (seq.imu_t > t_prev) & (seq.imu_t <= fr.timestamp)
            imu = [(float(t), a, g) for t, a, g in
                   zip(seq.imu_t[sel], seq.imu_acc[sel], seq.imu_gyro[sel])]
            t_prev = fr.timestamp
        fetches0 = sum(series.get("device_fetches", ()))
        t0 = time.perf_counter()
        system.track_stereo(fr.left, fr.right, fr.timestamp, imu=imu)
        rows.append(((time.perf_counter() - t0) * 1e3,
                     sum(series.get("device_fetches", ())) - fetches0,
                     system.tracking_state == TrackingState.OK,
                     system.atlas.current.imu_initialized))
    system.shutdown()
    return system, rows


def system_report(system, rows, seq, inertial: bool):
    from fasttrack_tpu.evaluation import absolute_trajectory_error

    traj = system.tracker.trajectory
    ate = absolute_trajectory_error(
        np.asarray([t for t, _, _ in traj]),
        np.asarray([-R.T @ t for _, R, t in traj]),
        seq.gt_t, seq.gt_pos,
    )
    ms = np.asarray([r[0] for r in rows])
    tracked = float(np.mean([r[2] for r in rows]))
    m = system.atlas.current
    ok = ate["rmse"] < ATE_MAX_M and tracked >= TRACKED_MIN
    out = {
        "frames": len(rows),
        "first_frame_s": round(ms[0] / 1e3, 3),
        "ate_rmse_m": ate["rmse"],
        "tracked": round(tracked, 4),
        "keyframes": m.n_keyframes(), "mappoints": m.n_mappoints(),
        "n_loops_closed": (system.loop_closer.n_loops_closed
                           if system.loop_closer is not None else 0),
        "median_tracking_ms": float(np.median(ms[1:])),
        "p90_tracking_ms": float(np.percentile(ms[1:], 90)),
        "median_device_fetches_per_frame": float(np.median([r[1] for r in rows])),
    }
    if inertial:
        out["imu_initialized"] = bool(m.imu_initialized)
        out["imu_initialized_at_frame"] = next(
            (i for i, r in enumerate(rows) if r[3]), None)
        ok = ok and m.imu_initialized
    return ok, out


def phase_system(seq, n_frames: int, inertial: bool, h: int = H, w: int = W):
    """Phases 4 and 5: the full System through `track_stereo`."""
    system, rows = run_system(seq, n_frames, inertial, h, w)
    return system_report(system, rows, seq, inertial)


def _centers(poses) -> np.ndarray:
    return -np.einsum("kji,kj->ki", np.asarray(poses.R), np.asarray(poses.t))


def phase_dist_ba(devices):
    """Distributed BA on a mesh of `devices` against the one-device solve
    of the same realistic window (40 keyframes, 4096 points, 6 obs/point).

    Poses are compared after 8 damped Gauss-Newton steps taken in lockstep
    (damping 1e-2, every step kept), where the two programs differ only in
    the order of their sums. The full LM solves are compared by
    final cost: their host-side accept/reject can branch differently when
    two f32 costs differ in the last bits, and the window's last keyframes
    are weakly observed, so LM endpoints may differ along that direction."""
    from fasttrack_tpu.parallel import (
        distributed_ba_iteration,
        distributed_bundle_adjustment,
        make_mesh,
    )
    from fasttrack_tpu.parallel.synthetic_window import make_problem

    prob, cam, bf, n_obs = make_problem(K=40, L=4096, obs_per_point=6)
    out = {}
    for n in (len(devices), 1):
        mesh = make_mesh(n)
        t0 = time.perf_counter()
        p = prob
        for _ in range(8):
            poses, points = distributed_ba_iteration(p, cam, bf, mesh, 1e-2)
            p = p._replace(poses=poses, points=points)
        shards = {s.device for s in points.addressable_shards}
        lm_poses, _, costs, _, _ = distributed_bundle_adjustment(
            prob, cam, bf, mesh, iters=20)
        out[n] = (_centers(p.poses), costs, _centers(lm_poses), shards,
                  time.perf_counter() - t0)
    gn_n, costs_n, lm_n, shards_n, sec_n = out[len(devices)]
    gn_1, costs_1, lm_1, _, sec_1 = out[1]
    gn_diff = float(np.abs(gn_n - gn_1).max())
    rel = abs(costs_n[-1] - costs_1[-1]) / costs_1[-1]
    ok = (gn_diff <= 1e-4 and rel <= 1e-3 and costs_n[-1] < costs_n[0]
          and len(shards_n) == len(devices))
    return ok, {
        "window": {"keyframes": 40, "points": 4096, "observations": n_obs},
        "gn_steps_max_center_diff_m": gn_diff,
        "lm_cost_initial": costs_n[0], "lm_cost_final_mesh": costs_n[-1],
        "lm_cost_final_one_device": costs_1[-1], "lm_cost_rel_diff": rel,
        "lm_max_center_diff_m": float(np.abs(lm_n - lm_1).max()),
        "point_shards_on_distinct_devices": len(shards_n),
        "wall_s_mesh_incl_compile": round(sec_n, 3),
        "wall_s_one_device_incl_compile": round(sec_1, 3),
    }


def phase_sharded_extract(devices, h: int = H, w: int = W):
    """sharded_extract_batch of one frame per device against per-frame
    extraction on the default device."""
    import jax

    from fasttrack_tpu.datasets.synthetic import generate_sequence
    from fasttrack_tpu.ops import OrbConfig
    from fasttrack_tpu.ops.extractor import extract_orb
    from fasttrack_tpu.parallel import make_mesh, sharded_extract_batch

    n = len(devices)
    cfg = OrbConfig(height=h, width=w, n_features=N_FEATURES, n_levels=N_LEVELS)
    seq = generate_sequence(n_frames=n, h=h, w=w, seed=3)
    imgs = np.stack([f.left for f in seq.frames]).clip(0, 255).astype(np.float32)
    kps = sharded_extract_batch(jax.numpy.asarray(imgs), cfg, make_mesh(n))
    shard_devices = {s.device for s in kps.x.addressable_shards}
    batch = _keypoints_host(kps)
    worst_overlap, worst_bits = 1.0, 0.0
    for i in range(n):
        single = _keypoints_host(extract_orb(jax.numpy.asarray(imgs[i]), cfg)[0])
        cmp = compare_keypoints({k: v[i] for k, v in batch.items()}, single)
        worst_overlap = min(worst_overlap, cmp["overlap"])
        worst_bits = max(worst_bits, cmp["desc_bits"])
    ok = (len(shard_devices) == n and worst_overlap >= KP_OVERLAP_MIN
          and worst_bits <= DESC_BITS_MAX)
    return ok, {"frames": n, "shards_on_distinct_devices": len(shard_devices),
                "min_kp_overlap": round(worst_overlap, 4),
                "max_desc_mean_bits_diff": round(worst_bits, 3)}


# -------------------------------------------------------------------- main
def run_phase(name, fn, card, compiles):
    c0, t0 = compiles.seconds, time.perf_counter()
    try:
        ok, result = fn()
    except Exception:  # a failed phase is reported, the others still run
        traceback.print_exc()
        ok, result = False, {"error": "exception (traceback on stderr)"}
    wall = time.perf_counter() - t0
    print(f"phase {name}: {'ok' if ok else 'FAIL'} wall_s={wall:.3f} "
          f"compile_s={compiles.seconds - c0:.3f} "
          f"{json.dumps(result, default=float)} [{card}]", flush=True)
    return ok


def main(argv) -> int:
    four_cards = "--four-cards" in argv
    keep_cpu_platform()
    import jax

    from fasttrack_tpu.compile_cache import enable_compile_cache

    t0 = time.perf_counter()
    try:
        gpus = require_gpu(jax.devices(), 4 if four_cards else 1)
        cards = card_names()
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        print(f"phase device: FAIL {e}", flush=True)
        return 1
    cache = enable_compile_cache()
    compiles = Compiles()
    card = cards[0]
    for i, line in enumerate(cards):
        print(f"card {i}: {line}", flush=True)
    print(f"phase device: ok wall_s={time.perf_counter() - t0:.3f} "
          f"{gpus[0].device_kind} x{len(gpus)} compile_cache={cache} [{card}]",
          flush=True)

    if four_cards:
        phases = [
            ("dist_ba", lambda: phase_dist_ba(gpus)),
            ("sharded_extract", lambda: phase_sharded_extract(gpus)),
        ]
    else:
        from fasttrack_tpu.datasets.synthetic import generate_sequence

        cpu = jax.devices("cpu")[0]
        print(PRECISION_NOTE, flush=True)
        seqs = {}

        def render():
            t = time.perf_counter()
            seqs["loop"] = generate_sequence(
                n_frames=SYSTEM_FRAMES, h=H, w=W, seed=0, trajectory="loop")
            return True, {"frames": SYSTEM_FRAMES, "host_render_s":
                          round(time.perf_counter() - t, 3)}

        phases = [
            ("parity", lambda: phase_parity(gpus[0], cpu)),
            ("hot_path", lambda: phase_hot_path(gpus[0], cpu)),
            ("render", render),
            ("stereo_system",
             lambda: phase_system(seqs["loop"], SYSTEM_FRAMES, False)),
            ("stereo_inertial_system",
             lambda: phase_system(seqs["loop"], INERTIAL_FRAMES, True)),
        ]
    ok = True
    for name, fn in phases:
        ok = run_phase(name, fn, card, compiles) and ok
    print(f"total wall_s={time.perf_counter() - t0:.3f} [{card}]", flush=True)
    if not ok:
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
