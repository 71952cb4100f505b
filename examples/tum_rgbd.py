#!/usr/bin/env python3
"""TUM RGB-D driver, mirroring Examples/RGB-D/rgbd_tum.cc: rgb.txt/depth.txt
nearest-timestamp association, depth factor 5000, TUM trajectory out.

Usage:
  python examples/tum_rgbd.py SETTINGS.yaml SEQ_DIR \
      [--mode 1111] [--po 1] [--out results/]
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
    ap.add_argument("--mode", default="1111")
    ap.add_argument("--po", type=int, default=1)
    ap.add_argument("--out", default="results")
    ap.add_argument("--gt", default=None,
                    help="ground-truth trajectory (EuRoC CSV or TUM "
                         "format) for ATE evaluation")
    ap.add_argument("--async-mapping", action="store_true")
    args = ap.parse_args()

    from fasttrack_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    from fasttrack_tpu.datasets import TumRgbdSequence
    from fasttrack_tpu.kernels import KernelConfig
    from fasttrack_tpu.settings import load_settings
    from fasttrack_tpu.system import Sensor, System

    settings = load_settings(args.settings)
    seq = TumRgbdSequence(args.sequence)
    if getattr(settings, "depth_map_factor", None):
        seq.depth_factor = settings.depth_map_factor
    kcfg = KernelConfig.from_bitmask(args.mode, pose_optimization=bool(args.po))
    system = System(settings, Sensor.RGBD, kernel_config=kcfg,
                    async_mapping=args.async_mapping)

    t0 = time.perf_counter()
    for i in range(len(seq)):
        ts, rgb, depth = seq[i]
        system.track_rgbd(rgb, depth, ts)
        if i % 100 == 0:
            print(f"frame {i}/{len(seq)} state={system.tracking_state.name}")
    wall = time.perf_counter() - t0
    system.shutdown()

    os.makedirs(args.out, exist_ok=True)
    system.save_trajectory_tum(os.path.join(args.out, "f_traj.txt"))
    system.save_keyframe_trajectory_tum(os.path.join(args.out, "kf_traj.txt"))
    system.save_stats(args.out)
    print(f"done: {len(seq)} frames in {wall:.1f}s "
          f"({system.stats.mean('tracking_total'):.2f} ms/frame tracking)")
    if args.gt:
        from fasttrack_tpu.evaluation import report_ate

        report_ate(system, args.gt, args.out, with_scale=False)


if __name__ == "__main__":
    main()
