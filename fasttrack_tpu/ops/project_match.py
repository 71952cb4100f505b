"""Masked search-by-projection matching — the workhorse of tracking.

Parity targets:
- SearchLocalPointsKernel.cu:71-344 (map-point -> frame matching for
  TrackLocalMap; radius/level-gated best + second-best Hamming with the
  level-aware ratio test, ORBmatcher.cc:227-309).
- PoseEstimationKernel.cu:61-348 (last-frame -> current-frame matching for
  TrackWithMotionModel with forward/backward octave gating,
  ORBmatcher.cc:1775-2085) including the rotation-histogram consistency
  filter (ComputeThreeMaxima, ORBmatcher.cc:2210).

Design: instead of walking a 64x48 grid per query, the full (M, N) Hamming
matrix is ONE int8 matmul; the TOP_K best-Hamming candidates per query are
kept (lax.top_k), and all window / octave gating is applied as additive
float penalties over the small (M, K) candidate list; validity/taken gates
enter the big matrix only as rank-1 broadcast penalties. Semantics are exact
unless a true in-window match falls outside the K best-Hamming candidates
(negligible for real descriptors; the reference's grid has per-cell caps
too).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from fasttrack_tpu.ops.hamming import hamming_matrix_f32

TH_HIGH = 100  # ORBmatcher.cc:41
TH_LOW = 50    # ORBmatcher.cc:42
HISTO_LENGTH = 30
# Python floats, so they trace as compile-time literals.
BIG = 1e9
PEN = 1e6
TOP_K = 64     # Hamming candidates per query kept for window gating


class MatchResult(NamedTuple):
    idx: jnp.ndarray    # (M,) int32 best frame-keypoint index (undefined if !ok)
    dist: jnp.ndarray   # (M,) float32 best Hamming distance (exact integer)
    ok: jnp.ndarray     # (M,) bool


def _arith_one_hot(idx, n):
    iota = jnp.arange(n, dtype=jnp.float32)
    return jnp.maximum(
        1.0 - jnp.abs(iota[None, :] - idx.astype(jnp.float32)[..., None]), 0.0
    )


@functools.partial(jax.jit, static_argnames=("max_dist", "ratio"))
def search_by_projection(
    q_u: jnp.ndarray,         # (M,) projected query u, level-0 px
    q_v: jnp.ndarray,         # (M,)
    q_desc: jnp.ndarray,      # (M, 256) int8
    q_radius: jnp.ndarray,    # (M,) search window radius (px)
    q_level_min: jnp.ndarray, # (M,) int32 inclusive octave gate
    q_level_max: jnp.ndarray, # (M,) int32 inclusive
    q_valid: jnp.ndarray,     # (M,) bool
    kp_x: jnp.ndarray,        # (N,) frame keypoint positions
    kp_y: jnp.ndarray,        # (N,)
    kp_desc: jnp.ndarray,     # (N, 256) int8
    kp_level: jnp.ndarray,    # (N,) int32
    kp_valid: jnp.ndarray,    # (N,) bool
    kp_taken: jnp.ndarray | None = None,  # (N,) bool: already bound to a map point
    max_dist: int = TH_HIGH,
    ratio: float | None = None,           # level-aware second-best ratio (0.8 SLP)
) -> MatchResult:
    """Best-match search with square-window + octave gating.

    The window test is the square |du|<=r, |dv|<=r — identical to the
    reference's Frame::GetFeaturesInArea gate — applied as a float penalty.
    """
    # rank-1 validity/taken penalties, broadcast over the Hamming matrix
    q_pen = (1.0 - q_valid.astype(jnp.float32)) * BIG
    k_pen = (1.0 - kp_valid.astype(jnp.float32)) * BIG
    if kp_taken is not None:
        k_pen = k_pen + kp_taken.astype(jnp.float32) * BIG
    dm = hamming_matrix_f32(q_desc, kp_desc) + q_pen[:, None] + k_pen[None, :]

    K = min(TOP_K, dm.shape[1])
    neg_cd, ni = jax.lax.top_k(-dm, K)        # (M, K)
    cd = -neg_cd
    c_u = kp_x[ni]
    c_v = kp_y[ni]
    c_l = kp_level[ni].astype(jnp.float32)
    du = jnp.abs(c_u - q_u[:, None])
    dv = jnp.abs(c_v - q_v[:, None])
    pen = (
        jnp.maximum(du - q_radius[:, None], 0.0)
        + jnp.maximum(dv - q_radius[:, None], 0.0)
        + jnp.maximum(q_level_min[:, None].astype(jnp.float32) - c_l, 0.0)
        + jnp.maximum(c_l - q_level_max[:, None].astype(jnp.float32), 0.0)
    ) * PEN
    cdp = cd + pen                             # (M, K)
    j = jnp.argmin(cdp, axis=1)
    best_idx = jnp.take_along_axis(ni, j[:, None], axis=1)[:, 0].astype(jnp.int32)
    best_dist = jnp.min(cdp, axis=1)
    ok = best_dist <= max_dist

    if ratio is not None:
        best_level = jnp.take_along_axis(
            c_l, j[:, None], axis=1
        )[:, 0].astype(jnp.int32)
        # knock out the chosen candidate in the SMALL (M, K) list
        cdp2 = cdp + _arith_one_hot(j, K) * BIG
        j2 = jnp.argmin(cdp2, axis=1)
        second_dist = jnp.min(cdp2, axis=1)
        second_level = jnp.take_along_axis(
            c_l, j2[:, None], axis=1
        )[:, 0].astype(jnp.int32)
        # ORBmatcher.cc:293-296: apply the ratio only when best and second
        # best live on the same pyramid level.
        reject = (best_level == second_level) & (best_dist > ratio * second_dist)
        ok = ok & ~reject

    return MatchResult(best_idx, best_dist, ok)


def rotation_consistency(
    q_angle: jnp.ndarray,   # (M,) reference angles (e.g. last-frame keypoints)
    kp_angle: jnp.ndarray,  # (N,) current-frame keypoint angles
    res: MatchResult,
) -> jnp.ndarray:
    """Keep only matches whose angle difference falls in the 3 dominant
    30-bin histogram buckets (ORBmatcher.cc ComputeThreeMaxima :2210)."""
    dtheta = q_angle - kp_angle[res.idx]
    frac = (dtheta / (2 * jnp.pi)) % 1.0
    bins = jnp.clip((frac * HISTO_LENGTH).astype(jnp.int32), 0, HISTO_LENGTH - 1)
    # histogram via arithmetic one-hot (no predicate intermediates)
    hist = jnp.sum(
        _arith_one_hot(bins, HISTO_LENGTH) * res.ok[:, None].astype(jnp.float32),
        axis=0,
    )
    top3 = jax.lax.top_k(hist, 3)[0]
    # ORBmatcher: drop bins 2/3 when much weaker than the best bin.
    keep2 = top3[1] >= 0.1 * top3[0]
    keep3 = top3[2] >= 0.1 * top3[0]
    order = jnp.argsort(-hist)
    allowed = (bins == order[0]) | (keep2 & (bins == order[1])) | (
        keep3 & (bins == order[2])
    )
    return res.ok & allowed


@jax.jit
def twm_match(
    q_u, q_v, q_desc, q_radius, q_level_min, q_level_max, q_valid,
    kp_x, kp_y, kp_desc, kp_level, kp_valid, q_angle, kp_angle,
):
    """TrackWithMotionModel matcher: search + rotation-histogram filter +
    per-keypoint dedup, as ONE compiled program."""
    res = search_by_projection(
        q_u, q_v, q_desc, q_radius, q_level_min, q_level_max, q_valid,
        kp_x, kp_y, kp_desc, kp_level, kp_valid,
    )
    keep = rotation_consistency(q_angle, kp_angle, res)
    keep = keep & resolve_duplicates(res._replace(ok=keep), kp_x.shape[0])
    return res.idx, keep


@jax.jit
def tlm_match(
    q_u, q_v, q_desc, q_radius, q_level_min, q_level_max, q_valid,
    kp_x, kp_y, kp_desc, kp_level, kp_valid, kp_taken,
):
    """TrackLocalMap matcher: search with taken-mask + level-aware ratio +
    dedup, one compiled program."""
    res = search_by_projection(
        q_u, q_v, q_desc, q_radius, q_level_min, q_level_max, q_valid,
        kp_x, kp_y, kp_desc, kp_level, kp_valid, kp_taken=kp_taken, ratio=0.8,
    )
    keep = res.ok & resolve_duplicates(res, kp_x.shape[0])
    return res.idx, keep


@jax.jit
def epipolar_match(
    u1, v1, desc1, free1,     # KF1 keypoints (unbound only: free mask)
    u2, v2, desc2, free2,     # KF2 keypoints
    F12,                      # (3,3) fundamental with x2^T F12 x1 = 0
    sigma2_2,                 # (N2,) level variance in image 2
):
    """Epipolar-constrained descriptor matching for triangulation
    (ORBmatcher::SearchForTriangulation, ORBmatcher.cc:1006): best Hamming
    match under TH_LOW with the point-to-epiline chi2 gate (as a float
    penalty)."""
    d = hamming_matrix_f32(desc1, desc2)  # (N1, N2)
    dm = d + (1.0 - free1.astype(jnp.float32))[:, None] * BIG
    dm = dm + (1.0 - free2.astype(jnp.float32))[None, :] * BIG
    K = min(TOP_K, dm.shape[1])
    neg_cd, ni = jax.lax.top_k(-dm, K)        # (N1, K)
    cd = -neg_cd
    # epilines as rank-1 arithmetic: l = F12 @ [u1, v1, 1]
    a = (F12[0, 0] * u1 + F12[0, 1] * v1 + F12[0, 2])[:, None]
    b = (F12[1, 0] * u1 + F12[1, 1] * v1 + F12[1, 2])[:, None]
    c = (F12[2, 0] * u1 + F12[2, 1] * v1 + F12[2, 2])[:, None]
    c_u = u2[ni]
    c_v = v2[ni]
    num = a * c_u + b * c_v + c               # (N1, K)
    dsq = num**2 / jnp.maximum(a**2 + b**2, 1e-12)
    cdp = cd + jnp.maximum(dsq - 3.84 * sigma2_2[ni], 0.0) * PEN
    j = jnp.argmin(cdp, axis=1)
    best_idx = jnp.take_along_axis(ni, j[:, None], axis=1)[:, 0].astype(jnp.int32)
    best = jnp.min(cdp, axis=1)
    ok = best <= TH_LOW
    # one-to-one: keep the best row per chosen column
    keep = ok & resolve_duplicates(MatchResult(best_idx, best, ok), u2.shape[0])
    return best_idx, keep


@jax.jit
def epipolar_match_tri_batch(
    u1, v1, d1, f1,           # (B, N1), (B, N1, 256), (B, N1) neighbor KFs
    u2, v2, d2, f2,           # (N2,), (N2, 256), (N2,)   current KF (shared)
    F12, sigma2_2,            # (B, 3, 3), (N2,)
    R21, t21,                 # (B, 3, 3), (B, 3)  camera2<-camera1 per pair
    fx, fy, cx, cy,
):
    """Batched SearchForTriangulation + DLT triangulation: ALL covisible
    neighbor pairs of one new keyframe as ONE XLA program (one dispatch +
    one fetch instead of 2 sequential round trips per neighbor). Returns
    (idx2 (B,N1) i32, keep (B,N1) bool, X1 (B,N1,3) f32 points in each
    neighbor's frame —
    rows with keep=False are garbage and must be masked by the host."""
    from fasttrack_tpu.cameras.stereo import triangulate_two_view
    from fasttrack_tpu.geometry import SE3

    def per(u1b, v1b, d1b, f1b, F12b, R21b, t21b):
        idx2, keep = epipolar_match(
            u1b, v1b, d1b, f1b, u2, v2, d2, f2, F12b, sigma2_2
        )
        r1 = jnp.stack(
            [(u1b - cx) / fx, (v1b - cy) / fy, jnp.ones_like(u1b)], -1
        )
        u2s, v2s = u2[idx2], v2[idx2]
        r2 = jnp.stack(
            [(u2s - cx) / fx, (v2s - cy) / fy, jnp.ones_like(u2s)], -1
        )
        X1 = triangulate_two_view(r1, r2, SE3(R21b, t21b))
        return idx2, keep, X1

    return jax.vmap(per)(u1, v1, d1, f1, F12, R21, t21)


def resolve_duplicates(res: MatchResult, n_keypoints: int) -> jnp.ndarray:
    """Per-keypoint winner among queries that chose it (min distance), like
    the reference host loop that overwrites F.mvpMapPoints[idx].

    Returns (M,) bool: query keeps its match."""
    m = res.idx.shape[0]
    key = res.dist + (1.0 - res.ok.astype(jnp.float32)) * BIG
    best_per_kp = jax.ops.segment_min(key, res.idx, num_segments=n_keypoints)
    winner_dist = best_per_kp[res.idx]
    is_winner = res.ok & (key == winner_dist)
    # Break exact-distance ties by query index: first query wins.
    qidx = jnp.arange(m, dtype=jnp.int32)
    tie_key = jnp.where(is_winner, qidx, jnp.int32(1 << 30))
    first_winner = jax.ops.segment_min(tie_key, res.idx, num_segments=n_keypoints)
    return is_winner & (qidx == first_winner[res.idx])


@jax.jit
def twm_match_packed(q7, q_desc, kp_x, kp_y, kp_desc, kp_level, kp_valid, kp_angle):
    """twm_match with the query side packed into ONE (7, M) f32 upload
    [u, v, radius, level_min, level_max, valid, angle]: one host->device
    transfer instead of seven."""
    return twm_match(
        q7[0], q7[1], q_desc, q7[2],
        q7[3].astype(jnp.int32), q7[4].astype(jnp.int32), q7[5] > 0.5,
        kp_x, kp_y, kp_desc, kp_level, kp_valid, q7[6], kp_angle,
    )


@jax.jit
def tlm_match_packed(q6, q_desc, kp_x, kp_y, kp_desc, kp_level, kp_valid, taken_f32):
    """tlm_match with the query side packed into ONE (6, M) f32 upload
    [u, v, radius, level_min, level_max, valid]."""
    return tlm_match(
        q6[0], q6[1], q_desc, q6[2],
        q6[3].astype(jnp.int32), q6[4].astype(jnp.int32), q6[5] > 0.5,
        kp_x, kp_y, kp_desc, kp_level, kp_valid, taken_f32 > 0.5,
    )
