#!/usr/bin/env python3
"""Experiment harness: sweep offload-toggle bitmasks x pose-opt on/off over
sequences, N iterations each (the reference's run_experiments.sh /
run_script.sh workflow, Results/poseOptimization_{on,off}/<mask>/... layout).

Default runs the synthetic sequence (no dataset needed); pass --euroc for a
real EuRoC directory.

The runs go one after another, one driver process at a time: each driver is
a JAX process that reserves most of the accelerator's memory when it starts,
so a second one running beside it on the same card would fail.
"""

import argparse
import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", nargs="*",
                    default=["0000", "1000", "1100", "1111"])
    ap.add_argument("--po", nargs="*", default=["on", "off"])
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--results", default="Results")
    ap.add_argument("--euroc", default=None, help="EuRoC sequence dir")
    ap.add_argument("--settings", default=None, help="YAML (with --euroc)")
    ap.add_argument("--gt", default=None,
                    help="ground-truth file: every run also reports ATE "
                         "(euroc_eval_examples.sh role)")
    args = ap.parse_args()

    for mode, po, it in itertools.product(args.modes, args.po, range(args.iters)):
        out = os.path.join(
            args.results, f"poseOptimization_{po}", mode, f"run{it}"
        )
        os.makedirs(out, exist_ok=True)
        if args.euroc:
            cmd = [sys.executable, os.path.join(HERE, "stereo_euroc.py"),
                   args.settings, args.euroc,
                   "--mode", mode, "--po", "1" if po == "on" else "0",
                   "--out", out]
            if args.gt:
                cmd += ["--gt", args.gt]
        else:
            cmd = [sys.executable, os.path.join(HERE, "run_synthetic.py"),
                   "--frames", str(args.frames),
                   "--mode", mode, "--po", "1" if po == "on" else "0",
                   "--out", out]
        print("==>", " ".join(cmd))
        with open(os.path.join(out, "ostream.txt"), "w") as log:
            subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, check=False)

    # aggregate mean tracking times (the absent calculate_average_results.py)
    summary = {}
    for mode, po in itertools.product(args.modes, args.po):
        times = []
        base = os.path.join(args.results, f"poseOptimization_{po}", mode)
        for it in range(args.iters):
            p = os.path.join(base, f"run{it}", "summary.json")
            if os.path.exists(p):
                with open(p) as f:
                    s = json.load(f)
                if "tracking_total" in s:
                    times.append(s["tracking_total"]["mean"])
        if times:
            summary[f"{mode}/po_{po}"] = sum(times) / len(times)
        ates = []
        for it in range(args.iters):
            p = os.path.join(base, f"run{it}", "ate.json")
            if os.path.exists(p):
                with open(p) as f:
                    ates.append(json.load(f)["ate_rmse"])
        if ates:
            summary[f"{mode}/po_{po}/ate_rmse"] = sum(ates) / len(ates)
    print(json.dumps(summary, indent=2))
    with open(os.path.join(args.results, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)


if __name__ == "__main__":
    main()
