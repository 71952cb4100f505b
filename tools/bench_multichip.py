#!/usr/bin/env python3
"""Multichip dist-BA scaling benchmark on the virtual CPU mesh.

Runs the landmark-sharded Schur-complement LM (parallel/dist_ba.py) on a
realistic covisibility window (default 100 KFs / 10k points, ~8
observations per point) at N = 1, 2, 4, 8 devices and reports
iterations/second per N.

CAVEAT printed with the result: run as a script, it forces the CPU with 8
virtual devices, which share one physical CPU, so the table validates the
sharded program (collective placement, per-shard work division) and
measures framework overhead vs N. It is not a device measurement.

Usage:  python tools/bench_multichip.py [--processes N]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

from fasttrack_tpu.parallel.synthetic_window import make_problem  # noqa: E402


def _force_virtual_cpu_mesh():
    """Run on the CPU with 8 virtual devices (before any backend is
    initialised)."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update("jax_platforms", "cpu")


def worker(process_id: int, num_processes: int, port: int):
    """Multi-process worker: join the process group, build the
    SAME seeded window on every process, shard it over the GLOBAL mesh, and
    run the landmark-sharded LM — cross-process psum over Gloo."""
    from fasttrack_tpu.parallel import (
        distributed_bundle_adjustment,
        initialize_distributed,
        make_global_mesh,
        shard_ba_problem,
    )

    joined = initialize_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=num_processes, process_id=process_id,
    )
    assert joined
    K = int(os.environ.get("BMC_K", 40))
    L = int(os.environ.get("BMC_L", 4096))
    iters = int(os.environ.get("BMC_ITERS", 6))
    prob, cam, bf, n_obs = make_problem(K=K, L=L, obs_per_point=6)
    mesh = make_global_mesh()
    gprob = shard_ba_problem(prob, mesh)
    t0 = time.perf_counter()
    _, _, costs, inlier, _ = distributed_bundle_adjustment(
        gprob, cam, bf, mesh, iters=iters
    )
    dt = time.perf_counter() - t0
    if process_id == 0:
        print("MULTIHOST " + json.dumps({
            "bench": "dist_ba_multihost",
            "processes": num_processes,
            "global_devices": len(jax.devices()),
            "local_devices": len(jax.local_devices()),
            "window": {"keyframes": K, "points": L, "observations": n_obs},
            "iters": iters,
            "seconds": round(dt, 2),
            "cost_initial": round(float(costs[0]), 3),
            "cost_final": round(float(costs[-1]), 3),
        }), flush=True)


def run_multiprocess(num_processes: int, devices_per_process: int = 4,
                     port: int = 43217):
    """Spawn N local processes x M virtual CPU devices each and run the
    worker in every one (the multi-host dry-run available without N real
    hosts). Returns process 0's MULTIHOST json line."""
    import subprocess

    here = os.path.abspath(__file__)
    procs = []
    for pid in range(num_processes):
        env = dict(os.environ)
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={devices_per_process}"
        )
        env["JAX_PLATFORMS"] = "cpu"
        env["BMC_WORKER"] = f"{pid}:{num_processes}:{port}"
        env["PYTHONPATH"] = (
            os.path.dirname(os.path.dirname(here))
            + os.pathsep + env.get("PYTHONPATH", "")
        )
        procs.append(subprocess.Popen(
            [sys.executable, here], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"worker failed rc={p.returncode}:\n{o[-2000:]}")
    for line in outs[0].splitlines():
        if line.startswith("MULTIHOST "):
            print(line, flush=True)
            return json.loads(line[len("MULTIHOST "):])
    raise RuntimeError(f"no MULTIHOST line in worker 0 output:\n{outs[0][-2000:]}")


def main():
    from fasttrack_tpu.parallel import distributed_bundle_adjustment, make_mesh

    K = int(os.environ.get("BMC_K", 100))
    L = int(os.environ.get("BMC_L", 10240))
    iters = int(os.environ.get("BMC_ITERS", 8))
    prob, cam, bf, n_obs = make_problem(K=K, L=L)
    table = []
    for n in (1, 2, 4, 8):
        if n > len(jax.devices()):
            continue
        mesh = make_mesh(n)
        # warmup (compile)
        distributed_bundle_adjustment(prob, cam, bf, mesh, iters=1)
        t0 = time.perf_counter()
        _, _, costs, _, _ = distributed_bundle_adjustment(
            prob, cam, bf, mesh, iters=iters
        )
        dt = time.perf_counter() - t0
        table.append({
            "n_devices": n,
            "iters_per_s": round(iters / dt, 2),
            "s_per_iter": round(dt / iters, 3),
            "cost_initial": round(float(costs[0]), 1),
            "cost_final": round(float(costs[-1]), 3),
        })
        print(f"N={n}: {iters / dt:.2f} it/s  cost {costs[0]:.0f} -> {costs[-1]:.0f}")
    out = {
        "bench": "dist_ba_scaling",
        "window": {"keyframes": K, "points": L, "observations": n_obs},
        "iters": iters,
        "table": table,
        "caveat": "virtual CPU mesh shares one physical CPU: validates the "
                  "sharded program + overhead-vs-N, not a device measurement",
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    if os.environ.get("BMC_WORKER"):
        pid, nproc, port = os.environ["BMC_WORKER"].split(":")
        worker(int(pid), int(nproc), int(port))
    else:
        _force_virtual_cpu_mesh()
        if "--processes" in sys.argv:
            run_multiprocess(int(sys.argv[sys.argv.index("--processes") + 1]))
        else:
            main()
