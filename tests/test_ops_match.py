"""Tests for search-by-projection, rectified stereo, and fisheye matching."""

import numpy as np
import jax.numpy as jnp

from fasttrack_tpu.ops import extract_orb, OrbConfig
from fasttrack_tpu.ops.hamming import signed_descriptors
from fasttrack_tpu.ops.project_match import (
    MatchResult,
    resolve_duplicates,
    rotation_consistency,
    search_by_projection,
)
from fasttrack_tpu.ops.stereo_match import match_fisheye, match_rectified


def rand_desc(rng, n):
    return signed_descriptors(jnp.asarray(rng.integers(0, 2, size=(n, 256)).astype(np.uint8)))


class TestSearchByProjection:
    def make_frame(self, rng, n=128):
        uv = rng.uniform(20, 300, size=(n, 2)).astype(np.float32)
        desc = rand_desc(rng, n)
        level = rng.integers(0, 4, size=n).astype(np.int32)
        return jnp.asarray(uv), desc, jnp.asarray(level), jnp.ones(n, bool)

    def test_exact_recovery(self, rng):
        kp_uv, kp_desc, kp_level, kp_valid = self.make_frame(rng)
        sel = np.arange(0, 128, 3)
        q_uv = kp_uv[sel] + jnp.asarray(rng.uniform(-2, 2, size=(len(sel), 2)).astype(np.float32))
        res = search_by_projection(
            q_uv[:, 0], q_uv[:, 1], kp_desc[sel], jnp.full(len(sel), 4.0),
            kp_level[sel], kp_level[sel], jnp.ones(len(sel), bool),
            kp_uv[:, 0], kp_uv[:, 1], kp_desc, kp_level, kp_valid,
        )
        assert bool(res.ok.all())
        np.testing.assert_array_equal(np.asarray(res.idx), sel)
        assert int(res.dist.max()) == 0

    def test_radius_gate(self, rng):
        kp_uv, kp_desc, kp_level, kp_valid = self.make_frame(rng)
        q_uv = kp_uv[:8] + 50.0  # displaced beyond the radius
        res = search_by_projection(
            q_uv[:, 0], q_uv[:, 1], kp_desc[:8], jnp.full(8, 4.0),
            jnp.zeros(8, jnp.int32), jnp.full(8, 10, jnp.int32), jnp.ones(8, bool),
            kp_uv[:, 0], kp_uv[:, 1], kp_desc, kp_level, kp_valid,
        )
        assert not bool(res.ok.any())

    def test_level_gate(self, rng):
        kp_uv, kp_desc, kp_level, kp_valid = self.make_frame(rng)
        sel = np.where(np.asarray(kp_level) == 2)[0][:8]
        lo = jnp.full(len(sel), 3, jnp.int32)  # excludes level 2
        res = search_by_projection(
            kp_uv[sel, 0], kp_uv[sel, 1], kp_desc[sel], jnp.full(len(sel), 4.0),
            lo, jnp.full(len(sel), 4, jnp.int32), jnp.ones(len(sel), bool),
            kp_uv[:, 0], kp_uv[:, 1], kp_desc, kp_level, kp_valid,
        )
        # the exact-duplicate kp is excluded by level; any other kp within
        # radius 4 with a random descriptor will rarely pass TH_HIGH
        assert int(res.ok.sum()) <= 1

    def test_taken_mask(self, rng):
        kp_uv, kp_desc, kp_level, kp_valid = self.make_frame(rng)
        taken = jnp.zeros(128, bool).at[5].set(True)
        res = search_by_projection(
            kp_uv[5:6, 0], kp_uv[5:6, 1], kp_desc[5:6], jnp.full(1, 4.0),
            kp_level[5:6], kp_level[5:6], jnp.ones(1, bool),
            kp_uv[:, 0], kp_uv[:, 1], kp_desc, kp_level, kp_valid, kp_taken=taken,
        )
        assert not bool(res.ok[0])

    def test_ratio_rejects_ambiguous(self, rng):
        # Two near-identical keypoints on the same level near the query:
        # best=10, second=11 bits away -> 10 > 0.8*11 -> rejected.
        base = rng.integers(0, 2, size=(1, 256)).astype(np.uint8)
        k1 = base.copy(); k1[0, :10] ^= 1
        k2 = base.copy(); k2[0, 20:31] ^= 1
        far = rng.integers(0, 2, size=(2, 256)).astype(np.uint8)
        desc = signed_descriptors(jnp.asarray(base))
        kp_uv = jnp.asarray([[100.0, 100.0], [103.0, 100.0], [200.0, 200.0], [250.0, 250.0]])
        kp_desc = signed_descriptors(jnp.asarray(np.concatenate([k1, k2, far])))
        kp_level = jnp.zeros(4, jnp.int32)
        res = search_by_projection(
            kp_uv[:1, 0], kp_uv[:1, 1], desc[:1], jnp.full(1, 8.0),
            jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32), jnp.ones(1, bool),
            kp_uv[:, 0], kp_uv[:, 1], kp_desc, kp_level, jnp.ones(4, bool), ratio=0.8,
        )
        assert not bool(res.ok[0])

    def test_rotation_consistency(self, rng):
        n = 64
        kp_uv, kp_desc, kp_level, kp_valid = self.make_frame(rng, n)
        res = search_by_projection(
            kp_uv[:, 0], kp_uv[:, 1], kp_desc, jnp.full(n, 4.0),
            kp_level, kp_level, jnp.ones(n, bool),
            kp_uv[:, 0], kp_uv[:, 1], kp_desc, kp_level, kp_valid,
        )
        kp_angle = jnp.asarray(rng.uniform(0, 2 * np.pi, size=n).astype(np.float32))
        q_angle = kp_angle + 0.3  # consistent rotation
        q_angle = q_angle.at[:5].add(2.0)  # 5 outliers
        keep = rotation_consistency(q_angle, kp_angle, res)
        kept = np.asarray(keep)
        assert kept[5:].all()
        assert not kept[:5].any()

    def test_topk_parity_repetitive_texture(self, rng):
        """The TOP_K=64 candidate shortlist vs the exact masked argmin on a
        repetitive-texture frame (many low-Hamming out-of-window keypoints —
        the shortlist's worst case). Guards the approximation documented in
        the module docstring: agreement must stay >99%."""
        N, M, R = 1024, 256, 8.0
        codebook = rng.integers(0, 2, size=(8, 256)).astype(np.uint8)
        bits = codebook[rng.integers(0, 8, size=N)]
        flip = rng.random((N, 256)) < 0.02  # ~5 bits noise per descriptor
        bits = bits ^ flip.astype(np.uint8)
        kp_uv = rng.uniform(0, 640, size=(N, 2)).astype(np.float32)
        kp_level = rng.integers(0, 4, size=N).astype(np.int32)
        q_sel = rng.choice(N, M, replace=False)
        q_uv = kp_uv[q_sel] + rng.uniform(-4, 4, size=(M, 2)).astype(np.float32)
        q_bits = bits[q_sel] ^ (rng.random((M, 256)) < 0.02).astype(np.uint8)
        lmin = np.maximum(kp_level[q_sel] - 1, 0)
        lmax = np.minimum(kp_level[q_sel] + 1, 3)

        res = search_by_projection(
            jnp.asarray(q_uv[:, 0]), jnp.asarray(q_uv[:, 1]),
            signed_descriptors(jnp.asarray(q_bits)), jnp.full(M, R),
            jnp.asarray(lmin), jnp.asarray(lmax), jnp.ones(M, bool),
            jnp.asarray(kp_uv[:, 0]), jnp.asarray(kp_uv[:, 1]),
            signed_descriptors(jnp.asarray(bits)), jnp.asarray(kp_level),
            jnp.ones(N, bool),
        )
        # exact oracle: masked argmin over the full (M, N) Hamming matrix
        ham = (q_bits[:, None, :] != bits[None, :, :]).sum(-1)  # (M, N)
        in_win = (
            (np.abs(kp_uv[None, :, 0] - q_uv[:, None, 0]) <= R)
            & (np.abs(kp_uv[None, :, 1] - q_uv[:, None, 1]) <= R)
            & (kp_level[None, :] >= lmin[:, None])
            & (kp_level[None, :] <= lmax[:, None])
        )
        ham_m = np.where(in_win, ham, 10**6)
        oracle_idx = ham_m.argmin(1)
        oracle_ok = ham_m.min(1) <= 100
        got_idx = np.asarray(res.idx)
        got_ok = np.asarray(res.ok)
        agree = (got_ok == oracle_ok) & (~oracle_ok | (got_idx == oracle_idx))
        assert agree.mean() > 0.99, f"top-K parity {agree.mean():.3f}"

    def test_validity_and_taken_penalties(self, rng):
        """The rank-1 validity/taken penalties broadcast over the Hamming
        matrix: against a masked exact argmin, at the tile-aligned (M, N)
        shapes of the matchers."""
        M, N, R = 256, 128, 6.0
        kp_uv, kp_desc, kp_level, _ = self.make_frame(rng, N)
        kp_valid = rng.random(N) > 0.2
        taken = rng.random(N) < 0.2
        src = rng.integers(0, N, M)
        q_uv = np.asarray(kp_uv)[src] + rng.uniform(-2, 2, (M, 2)).astype(np.float32)
        q_valid = rng.random(M) > 0.2
        q_desc = np.asarray(kp_desc)[src]
        res = search_by_projection(
            jnp.asarray(q_uv[:, 0]), jnp.asarray(q_uv[:, 1]), jnp.asarray(q_desc),
            jnp.full(M, R), jnp.zeros(M, jnp.int32), jnp.full(M, 3, jnp.int32),
            jnp.asarray(q_valid), kp_uv[:, 0], kp_uv[:, 1], kp_desc, kp_level,
            jnp.asarray(kp_valid), kp_taken=jnp.asarray(taken),
        )
        ham = (256 - q_desc.astype(np.int32) @ np.asarray(kp_desc, np.int32).T) // 2
        uv = np.asarray(kp_uv)
        in_win = ((np.abs(uv[None, :, 0] - q_uv[:, None, 0]) <= R)
                  & (np.abs(uv[None, :, 1] - q_uv[:, None, 1]) <= R))
        allowed = in_win & q_valid[:, None] & (kp_valid & ~taken)[None, :]
        masked = np.where(allowed, ham, 10**6)
        want_ok = masked.min(1) <= 100
        got_ok, got_idx = np.asarray(res.ok), np.asarray(res.idx)
        np.testing.assert_array_equal(got_ok, want_ok)
        assert not got_ok[~q_valid].any()
        assert (kp_valid & ~taken)[got_idx[got_ok]].all()
        np.testing.assert_array_equal(
            np.asarray(res.dist)[got_ok], masked.min(1)[got_ok])

    def test_resolve_duplicates(self):
        idx = jnp.asarray([3, 3, 7], jnp.int32)
        dist = jnp.asarray([10, 4, 9], jnp.int32)
        ok = jnp.asarray([True, True, True])
        keep = np.asarray(resolve_duplicates(MatchResult(idx, dist, ok), 16))
        np.testing.assert_array_equal(keep, [False, True, True])


class TestRectifiedStereo:
    def test_constant_disparity(self, rng):
        cfg = OrbConfig(height=240, width=320, n_features=256, n_levels=4)
        small = rng.integers(0, 256, size=(30, 40))
        img = np.kron(small, np.ones((8, 8))).astype(np.float32)
        disp = 16.0
        img_r = np.roll(img, -int(disp), axis=1)
        kl, pl = extract_orb(jnp.asarray(img), cfg)
        kr, pr = extract_orb(jnp.asarray(img_r), cfg)
        scale_factors = jnp.asarray([cfg.scale_factor**l for l in range(4)])
        bf = jnp.asarray(100.0)
        res = match_rectified(
            kl.x, kl.y, kl.level, kl.desc_signed, kl.valid,
            kr.x, kr.y, kr.level, kr.desc_signed, kr.valid,
            pl.raw, pr.raw, kl.xl, kl.yl, scale_factors, bf, bf / 100.0,
        )
        valid = np.asarray(res.valid)
        assert valid.sum() > 30
        d = np.asarray(kl.x) - np.asarray(res.u_right)
        err = np.abs(d[valid] - disp)
        assert np.median(err) < 0.6
        depths = np.asarray(res.depth)[valid]
        np.testing.assert_allclose(np.median(depths), 100.0 / disp, rtol=0.05)


class TestFisheye:
    def test_identity_matching(self, rng):
        d = rand_desc(rng, 64)
        res = match_fisheye(d, jnp.ones(64, bool), d, jnp.ones(64, bool))
        assert bool(res.valid.all())
        np.testing.assert_array_equal(np.asarray(res.idx_right), np.arange(64))

    def test_ratio_rejects_duplicates(self, rng):
        d = rand_desc(rng, 8)
        d_dup = jnp.concatenate([d, d[:1]], axis=0)  # right has a duplicate of 0
        res = match_fisheye(d[:1], jnp.ones(1, bool), d_dup, jnp.ones(9, bool))
        assert not bool(res.valid[0])


class TestEpipolarBatch:
    """epipolar_match_tri_batch must agree with per-pair epipolar_match +
    triangulate_two_view (it replaced the sequential per-neighbor loop on
    the keyframe-creation critical path)."""

    def _pair(self, rng, n1=96, n2=96):
        fx = fy = 300.0
        cx, cy = 160.0, 120.0
        X = np.stack([rng.uniform(-2, 2, n1), rng.uniform(-1.5, 1.5, n1),
                      rng.uniform(4, 8, n1)], -1)
        R21 = np.eye(3)
        t21 = np.array([0.3, 0.0, 0.0])
        uv1 = np.stack([fx * X[:, 0] / X[:, 2] + cx,
                        fy * X[:, 1] / X[:, 2] + cy], -1)
        X2 = X @ R21.T + t21
        uv2 = np.stack([fx * X2[:, 0] / X2[:, 2] + cx,
                        fy * X2[:, 1] / X2[:, 2] + cy], -1)
        tx = np.array([[0, -t21[2], t21[1]], [t21[2], 0, -t21[0]],
                       [-t21[1], t21[0], 0]])
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        Kinv = np.linalg.inv(K)
        F12 = Kinv.T @ (tx @ R21) @ Kinv
        desc = rand_desc(rng, n1)
        return (uv1, uv2, desc, F12, R21, t21, X,
                (fx, fy, cx, cy))

    def test_matches_per_pair_kernels(self, rng):
        from fasttrack_tpu.cameras.stereo import triangulate_two_view
        from fasttrack_tpu.geometry import SE3
        from fasttrack_tpu.ops.project_match import (
            epipolar_match, epipolar_match_tri_batch,
        )

        B = 3
        pairs = [self._pair(rng) for _ in range(B)]
        fx, fy, cx, cy = pairs[0][7]
        n1 = n2 = 96
        u1 = np.stack([p[0][:, 0] for p in pairs]).astype(np.float32)
        v1 = np.stack([p[0][:, 1] for p in pairs]).astype(np.float32)
        d1 = np.stack([np.asarray(p[2]) for p in pairs])
        f1 = np.ones((B, n1), bool)
        # shared current KF = pair 0's image-2 keypoints and descriptors
        u2 = pairs[0][1][:, 0].astype(np.float32)
        v2 = pairs[0][1][:, 1].astype(np.float32)
        d2 = np.asarray(pairs[0][2])
        f2 = np.ones(n2, bool)
        F12 = np.stack([p[3] for p in pairs]).astype(np.float32)
        R21 = np.stack([p[4] for p in pairs]).astype(np.float32)
        t21 = np.stack([p[5] for p in pairs]).astype(np.float32)
        var2 = np.ones(n2, np.float32)

        idx_b, keep_b, X1_b = epipolar_match_tri_batch(
            jnp.asarray(u1), jnp.asarray(v1), jnp.asarray(d1),
            jnp.asarray(f1), jnp.asarray(u2), jnp.asarray(v2),
            jnp.asarray(d2), jnp.asarray(f2), jnp.asarray(F12),
            jnp.asarray(var2), jnp.asarray(R21), jnp.asarray(t21),
            jnp.float32(fx), jnp.float32(fy), jnp.float32(cx),
            jnp.float32(cy),
        )
        for b in range(B):
            idx_s, keep_s = epipolar_match(
                jnp.asarray(u1[b]), jnp.asarray(v1[b]), jnp.asarray(d1[b]),
                jnp.asarray(f1[b]), jnp.asarray(u2), jnp.asarray(v2),
                jnp.asarray(d2), jnp.asarray(f2), jnp.asarray(F12[b]),
                jnp.asarray(var2),
            )
            np.testing.assert_array_equal(np.asarray(keep_b)[b],
                                          np.asarray(keep_s))
            km = np.asarray(keep_s)
            np.testing.assert_array_equal(np.asarray(idx_b)[b][km],
                                          np.asarray(idx_s)[km])
            # triangulation parity for kept rows
            i1 = np.where(km)[0]
            i2 = np.asarray(idx_s)[i1]
            r1 = np.stack([(u1[b][i1] - cx) / fx, (v1[b][i1] - cy) / fy,
                           np.ones(len(i1))], -1).astype(np.float32)
            r2 = np.stack([(u2[i2] - cx) / fx, (v2[i2] - cy) / fy,
                           np.ones(len(i2))], -1).astype(np.float32)
            X_ref = np.asarray(triangulate_two_view(
                jnp.asarray(r1), jnp.asarray(r2),
                SE3(jnp.asarray(R21[b]), jnp.asarray(t21[b])),
            ))
            np.testing.assert_allclose(np.asarray(X1_b)[b][i1], X_ref,
                                       atol=1e-3)
        # pair 0 is self-consistent geometry: its matches triangulate near
        # the true 3D points
        b0_keep = np.asarray(keep_b)[0]
        assert b0_keep.sum() >= 50
        X_true = pairs[0][6]
        err = np.linalg.norm(np.asarray(X1_b)[0][b0_keep]
                             - X_true[b0_keep], axis=1)
        assert np.median(err) < 0.05
