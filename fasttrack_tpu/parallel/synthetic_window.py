"""A synthetic bundle-adjustment window at realistic size.

Used by the distributed-BA tools and checks (`tools/bench_multichip.py`,
`chip_smoke.py --four-cards`, `__graft_entry__.dryrun_multichip`). Importing
this module touches no JAX configuration.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def make_problem(K=100, L=10240, obs_per_point=8, seed=0):
    """Synthetic covisibility window: a forward trajectory viewing a point
    cloud; each point observed by `obs_per_point` consecutive keyframes."""
    from fasttrack_tpu.cameras import make_pinhole, project
    from fasttrack_tpu.geometry import SE3
    from fasttrack_tpu.optim import BAProblem

    rng = np.random.default_rng(seed)
    cam = make_pinhole(400.0, 400.0, 376.0, 240.0, 752, 480)
    bf = 40.0
    X = np.stack([
        rng.uniform(-8, 8, L), rng.uniform(-4, 4, L),
        rng.uniform(6, 20, L) + np.repeat(
            np.linspace(0, 0.4 * K, L // obs_per_point + 1),
            obs_per_point)[:L],
    ], -1).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = np.stack([np.zeros(K), np.zeros(K), -0.4 * np.arange(K)], -1)
    t = t.astype(np.float32)

    obs_uv = np.zeros((L, K, 2), np.float32)
    obs_ur = np.full((L, K), -1.0, np.float32)
    mask = np.zeros((L, K), bool)
    # point l is observed by obs_per_point KFs around its "birth" keyframe
    birth = (np.arange(L) * K // L).astype(np.int32)
    for l in range(L):
        for k in range(birth[l], min(birth[l] + obs_per_point, K)):
            Xc = R[k] @ X[l] + t[k]
            if Xc[2] < 0.5:
                continue
            u = 400.0 * Xc[0] / Xc[2] + 376.0
            v = 400.0 * Xc[1] / Xc[2] + 240.0
            if 0 <= u < 752 and 0 <= v < 480:
                obs_uv[l, k] = (u + rng.normal(0, 0.3), v + rng.normal(0, 0.3))
                obs_ur[l, k] = u - bf / Xc[2]
                mask[l, k] = True

    prob = BAProblem(
        poses=SE3(jnp.asarray(R), jnp.asarray(t + rng.normal(0, 0.02, t.shape)
                                              .astype(np.float32))),
        points=jnp.asarray(X + rng.normal(0, 0.05, X.shape).astype(np.float32)),
        obs_uv=jnp.asarray(obs_uv),
        obs_ur=jnp.asarray(obs_ur),
        inv_sigma2=jnp.ones((L, K)),
        mask=jnp.asarray(mask),
        cam_free=jnp.asarray(np.arange(K) >= 2),
        point_free=jnp.ones(L, bool),
    )
    return prob, cam, bf, int(mask.sum())
