#!/usr/bin/env python3
"""EuRoC stereo(-inertial) driver, mirroring
Examples/Stereo-Inertial/stereo_inertial_euroc.cc: positional kernel-toggle
flags, dataset path + timestamps file + YAML settings, trajectory + stats out.

Usage:
  python examples/stereo_euroc.py SETTINGS.yaml SEQ_DIR [TIMESTAMPS.txt] \
      [--mode 1111] [--po 1] [--out results/] [--imu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("timestamps", nargs="?", default=None)
    ap.add_argument("--mode", default="1111")
    ap.add_argument("--po", type=int, default=1)
    ap.add_argument("--out", default="results")
    ap.add_argument("--gt", default=None,
                    help="ground-truth trajectory (EuRoC CSV or TUM "
                         "format) for ATE evaluation")
    ap.add_argument("--imu", action="store_true")
    ap.add_argument("--async-mapping", action="store_true")
    args = ap.parse_args()

    from fasttrack_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    from fasttrack_tpu.datasets import EurocSequence
    from fasttrack_tpu.kernels import KernelConfig
    from fasttrack_tpu.settings import load_settings
    from fasttrack_tpu.system import Sensor, System

    settings = load_settings(args.settings)
    seq = EurocSequence(args.sequence, args.timestamps)
    kcfg = KernelConfig.from_bitmask(args.mode, pose_optimization=bool(args.po))
    sensor = Sensor.IMU_STEREO if args.imu else Sensor.STEREO
    system = System(settings, sensor, kernel_config=kcfg,
                    async_mapping=args.async_mapping)

    t_prev = None
    t0 = time.perf_counter()
    for i in range(len(seq)):
        ts, left, right = seq[i]
        imu = None
        if args.imu and seq.imu is not None and t_prev is not None:
            imu = seq.imu.between(t_prev, ts)
        system.track_stereo(left, right, ts, imu=imu)
        t_prev = ts
        if i % 100 == 0:
            print(f"frame {i}/{len(seq)} state={system.tracking_state.name}")
    wall = time.perf_counter() - t0
    system.shutdown()

    os.makedirs(args.out, exist_ok=True)
    system.save_trajectory_tum(os.path.join(args.out, "f_traj.txt"))
    system.save_trajectory_euroc(os.path.join(args.out, "f_traj_euroc.txt"))
    system.save_keyframe_trajectory_tum(os.path.join(args.out, "kf_traj.txt"))
    system.save_stats(args.out)
    print(f"done: {len(seq)} frames in {wall:.1f}s "
          f"({system.stats.mean('tracking_total'):.2f} ms/frame tracking)")
    if args.gt:
        from fasttrack_tpu.evaluation import report_ate

        report_ate(system, args.gt, args.out, with_scale=False)


if __name__ == "__main__":
    main()
