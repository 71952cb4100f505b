"""Multi-process groups for the distributed backend.

SURVEY.md section 5: tracking streams per host feeding a shared map, with
the landmark-sharded Schur BA reduced across every device of a
`jax.distributed` process group. The reference has no multi-node story
(single process, std::thread); this module is the extension point:

- `initialize_distributed(...)` joins the process group (coordinator
  address + process id, or env vars) — after it, `jax.devices()` is GLOBAL
  across processes and every jitted shard_map program in
  parallel/dist_ba.py runs multi-controller unchanged: XLA inserts the
  collectives across processes (NCCL between GPUs).
- `make_global_mesh()` builds the mesh over the global device list.
- `shard_ba_problem(...)` turns a host-replicated BAProblem into global
  jax.Arrays (landmark axis sharded, camera axis replicated) via
  `jax.make_array_from_callback`, the multi-controller ingestion path.

Tested with N local processes x M virtual CPU devices each (Gloo
collectives), available without N real hosts
(tools/bench_multichip.py --processes N).
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join (or skip) a multi-process JAX run.

    Arguments default to the FASTTRACK_COORDINATOR / FASTTRACK_NUM_PROCS /
    FASTTRACK_PROC_ID environment variables. Returns True when a process
    group was joined, False for the single-process no-op (num_processes
    unset or 1), so drivers can call this unconditionally."""
    coordinator_address = coordinator_address or os.environ.get(
        "FASTTRACK_COORDINATOR"
    )
    if num_processes is None:
        num_processes = int(os.environ.get("FASTTRACK_NUM_PROCS", "1"))
    if process_id is None:
        process_id = int(os.environ.get("FASTTRACK_PROC_ID", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_global_mesh(axis: str = "map") -> Mesh:
    """Mesh over the GLOBAL device list (all processes). Identical to
    parallel.make_mesh in single-process runs."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def _global_array(x_host: np.ndarray, mesh: Mesh, spec: P):
    sharding = NamedSharding(mesh, spec)
    x_host = np.asarray(x_host)
    return jax.make_array_from_callback(
        x_host.shape, sharding, lambda idx: x_host[idx]
    )


def shard_ba_problem(problem, mesh: Mesh, axis: str = "map"):
    """Host-replicated BAProblem -> global arrays matching dist_ba's specs:
    landmark-axis fields sharded over `axis`, camera fields replicated.
    Every process must pass the SAME host problem (each contributes the
    shards its local devices own)."""
    from fasttrack_tpu.geometry import SE3
    from fasttrack_tpu.optim.local_ba import BAProblem

    shard = P(axis)
    rep = P()
    return BAProblem(
        poses=SE3(
            _global_array(problem.poses.R, mesh, rep),
            _global_array(problem.poses.t, mesh, rep),
        ),
        points=_global_array(problem.points, mesh, shard),
        obs_uv=_global_array(problem.obs_uv, mesh, shard),
        obs_ur=_global_array(problem.obs_ur, mesh, shard),
        inv_sigma2=_global_array(problem.inv_sigma2, mesh, shard),
        mask=_global_array(np.asarray(problem.mask), mesh, shard),
        cam_free=_global_array(problem.cam_free, mesh, rep),
        point_free=_global_array(problem.point_free, mesh, shard),
    )
