#!/usr/bin/env python3
"""Render a synthetic stereo(-inertial) sequence to the EuRoC ASL on-disk
layout, with ground truth in the reference's GT format.

The build environment has no network, so the reference's dataset evaluation
(euroc_eval_examples.sh: run driver -> save f_traj -> evaluate ATE vs
evaluation/Ground_truth/EuRoC_left_cam/*_GT.txt) is reproduced with the
in-tree renderer: this tool writes

    <out>/mav0/cam0/data/<ns>.png     left grayscale frames
    <out>/mav0/cam1/data/<ns>.png     right frames
    <out>/mav0/imu0/data.csv          EuRoC IMU csv (ns, gyro xyz, acc xyz)
    <out>/gt.txt                      EuRoC GT CSV (ns, p_xyz, q_wxyz)
    <out>/settings.yaml               File.version-1.0 settings

so the REAL driver path (EurocSequence loader -> System -> trajectory saver
-> --gt ATE) runs end-to-end, exactly as it would on a downloaded MH01.

Usage: python tools/render_euroc_synthetic.py OUT_DIR [--frames 1000]
       [--trajectory loop] [--h 240] [--w 320] [--seed 3]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

BASE_NS = 1403636579763555584  # EuRoC-era epoch so loaders see realistic ns


def rot_to_quat_wxyz(R):
    """R_wc -> (qw, qx, qy, qz) (EuRoC GT stores body/cam-to-world)."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(R).as_quat()  # x, y, z, w
    return q[3], q[0], q[1], q[2]


def settings_yaml(seq, w: int, h: int, fps: float, imu: bool = True) -> str:
    """The File.version-1.0 settings of a rendered sequence (OpenCV
    FileStorage YAML, with the IMU block when `imu`)."""
    text = f"""%YAML:1.0
---
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: {seq.fx}
Camera1.fy: {seq.fy}
Camera1.cx: {seq.cx}
Camera1.cy: {seq.cy}
Camera.width: {w}
Camera.height: {h}
Camera.fps: {fps}
Camera.RGB: 1
Stereo.ThDepth: 60.0
Stereo.b: {seq.baseline}
ORBextractor.nFeatures: 512
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
"""
    if imu:
        # Synthetic body frame == cam0 frame (datasets/synthetic.py IMU
        # generation); the stream itself is noise-free, so the noise
        # densities below only size the preintegration covariance
        # (EuRoC-like values, Settings.cc IMU.* keys).
        text += """IMU.T_b_c1: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [1.0, 0.0, 0.0, 0.0,
          0.0, 1.0, 0.0, 0.0,
          0.0, 0.0, 1.0, 0.0,
          0.0, 0.0, 0.0, 1.0]
IMU.NoiseGyro: 1.7e-4
IMU.NoiseAcc: 2.0e-3
IMU.GyroWalk: 1.9e-5
IMU.AccWalk: 3.0e-3
IMU.Frequency: 200.0
"""
    return text


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--trajectory", default="loop", choices=["loop", "sweep"])
    ap.add_argument("--h", type=int, default=240)
    ap.add_argument("--w", type=int, default=320)
    ap.add_argument("--fps", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--no-imu", action="store_true")
    ap.add_argument("--blackout-at", type=int, default=None,
                    help="frame index where a featureless-gray stretch "
                         "starts (drives the LOST -> reloc/new-map path "
                         "through the real driver, Tracking.cc:2038-2089)")
    ap.add_argument("--blackout-len", type=int, default=12)
    args = ap.parse_args()

    from PIL import Image

    from fasttrack_tpu.datasets.synthetic import generate_sequence

    print(f"rendering {args.frames} frames ({args.trajectory}) ...")
    seq = generate_sequence(
        n_frames=args.frames, h=args.h, w=args.w, fps=args.fps,
        seed=args.seed, trajectory=args.trajectory,
    )

    cam0 = os.path.join(args.out, "mav0", "cam0", "data")
    cam1 = os.path.join(args.out, "mav0", "cam1", "data")
    os.makedirs(cam0, exist_ok=True)
    os.makedirs(cam1, exist_ok=True)

    gt_lines = [
        "#timestamp [ns],p_RS_R_x [m],p_RS_R_y [m],p_RS_R_z [m],"
        "q_RS_w [],q_RS_x [],q_RS_y [],q_RS_z []"
    ]
    for i, fr in enumerate(seq.frames):
        ns = BASE_NS + int(round(fr.timestamp * 1e9))
        blank = (args.blackout_at is not None
                 and args.blackout_at <= i < args.blackout_at + args.blackout_len)
        for path, img in ((cam0, fr.left), (cam1, fr.right)):
            if blank:
                img = np.full_like(img, 127.0)
            Image.fromarray(
                np.clip(img, 0, 255).astype(np.uint8)
            ).save(os.path.join(path, f"{ns}.png"))
        qw, qx, qy, qz = rot_to_quat_wxyz(fr.R_wc)
        p = fr.t_wc
        gt_lines.append(
            f"{ns}.0,{p[0]:.10f},{p[1]:.10f},{p[2]:.10f},"
            f"{qw:.10f},{qx:.10f},{qy:.10f},{qz:.10f}"
        )
    with open(os.path.join(args.out, "gt.txt"), "w") as f:
        f.write("\n".join(gt_lines) + "\n")

    if not args.no_imu:
        imu_dir = os.path.join(args.out, "mav0", "imu0")
        os.makedirs(imu_dir, exist_ok=True)
        rows = ["#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z"]
        for t, g, a in zip(seq.imu_t, seq.imu_gyro, seq.imu_acc):
            ns = BASE_NS + int(round(float(t) * 1e9))
            rows.append(
                f"{ns},{g[0]:.9f},{g[1]:.9f},{g[2]:.9f},"
                f"{a[0]:.9f},{a[1]:.9f},{a[2]:.9f}"
            )
        with open(os.path.join(imu_dir, "data.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")

    with open(os.path.join(args.out, "settings.yaml"), "w") as f:
        f.write(settings_yaml(seq, args.w, args.h, args.fps,
                              imu=not args.no_imu))
    print(f"wrote {len(seq.frames)} stereo frames + gt + settings under "
          f"{args.out}")


if __name__ == "__main__":
    main()
