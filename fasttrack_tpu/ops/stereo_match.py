"""Rectified and fisheye stereo descriptor matching.

Parity targets:
- findBestStereoMatchKernel (StereoMatchKernel.cu:151-199): per left
  keypoint, scan row-bucketed right keypoints within the disparity window,
  Hamming best match (TH_HIGH gate, octave gate +-1).
- refineStereoMatchKernel (StereoMatchKernel.cu:201-309): cooperative 11x11
  patch L1 correlation over +-5 px at the keypoint's octave, parabola
  sub-pixel fit -> mvuRight / mvDepth; followed by the host median-distance
  outlier cull (Frame.cc:1007-1063).
- fisheyeStereoMatchKernel (StereoMatchKernel.cu:311-348): brute-force
  all-pairs Hamming with the Lowe 0.7 ratio test.

Design: the row-bucket scan becomes a full (N_L, N_R) Hamming matmul, then
a TOP-K CANDIDATE architecture: `lax.top_k` keeps the K=32
best-Hamming candidates per left keypoint, and every gating window (row
band, disparity band, octave band) is applied as an additive float penalty
over the small (N, K) candidate list before the final argmin. Validity
gates enter the (N, M) matrix only as rank-1 broadcast penalties.

No (N, M) pairwise window terms or predicate masks are built: the big
matrix sees only rank-1 penalties, and all window arithmetic is on the
small (N, K) list. Semantics: exact except when a true in-window match
is not among the K best-Hamming candidates (vanishingly rare for real
descriptors; the reference's grid walk has analogous per-cell caps,
CudaUtils keypointsPerCell=20). The cooperative shared-memory refinement
becomes a whole-row gather + one-hot column matmul with a closed-form
parabola fit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from fasttrack_tpu.ops.hamming import hamming_matrix_f32

TH_HIGH = 100
# Python floats, so they trace as compile-time literals.
BIG = 1e9
PEN = 1e6   # per-unit window-excess penalty (>> 256 max Hamming)
TOP_K = 64    # Hamming candidates per query kept for window gating
W_PATCH = 5   # half window (11x11 patch), StereoMatchKernel refine
L_SHIFT = 5   # +-5 px sub-pixel search


def valid_penalty(valid) -> jnp.ndarray:
    """(n,) validity -> additive penalty (0 valid / 1e9 invalid)."""
    return (1.0 - valid.astype(jnp.float32)) * BIG


def band_penalty(x, lo, hi) -> jnp.ndarray:
    """Penalty for x outside [lo, hi] (0 inside), scaled by PEN."""
    return (jnp.maximum(lo - x, 0.0) + jnp.maximum(x - hi, 0.0)) * PEN


def arithmetic_one_hot(idx, n: int, dtype=jnp.float32) -> jnp.ndarray:
    """one_hot(idx, n) as pure float arithmetic (no predicate compare):
    max(1 - |iota - idx|, 0) — exact for integer-valued inputs."""
    iota = jnp.arange(n, dtype=jnp.float32)
    return jnp.maximum(
        1.0 - jnp.abs(iota[None, :] - idx.astype(jnp.float32)[..., None]), 0.0
    ).astype(dtype)


class StereoMatches(NamedTuple):
    u_right: jnp.ndarray  # (N,) float32, -1 where unmatched
    depth: jnp.ndarray    # (N,) float32, -1 where unmatched
    valid: jnp.ndarray    # (N,) bool


@jax.jit
def match_rectified(
    # left keypoints (x/y as separate 1-D arrays)
    l_x: jnp.ndarray,       # (N,) level-0 coords (undistorted/rectified)
    l_y: jnp.ndarray,       # (N,)
    l_level: jnp.ndarray,   # (N,)
    l_desc: jnp.ndarray,    # (N, 256) int8
    l_valid: jnp.ndarray,   # (N,)
    # right keypoints
    r_x: jnp.ndarray,       # (M,)
    r_y: jnp.ndarray,       # (M,)
    r_level: jnp.ndarray,   # (M,)
    r_desc: jnp.ndarray,    # (M, 256) int8
    r_valid: jnp.ndarray,   # (M,)
    # pyramids (raw level tensors) for sub-pixel refinement
    l_pyr: jnp.ndarray,     # (L, H, W)
    r_pyr: jnp.ndarray,     # (L, H, W)
    l_xl: jnp.ndarray,      # (N,) int32 left kp coords at native level
    l_yl: jnp.ndarray,      # (N,)
    scale_factors: jnp.ndarray,  # (L,)
    bf: jnp.ndarray,        # baseline * fx
    min_z: jnp.ndarray,     # baseline (minZ = b, Frame.cc:842)
) -> StereoMatches:
    """One-shot rectified stereo matching + refinement + median cull."""
    n = l_x.shape[0]
    d = hamming_matrix_f32(l_desc, r_desc)  # (N, M) float32

    # Validity as rank-1 penalties on the full matrix; then keep the TOP_K
    # best-Hamming candidates per left keypoint and gate those by the row
    # window |yR - yL| <= 2 * scale_L (the reference's row-bucket radius,
    # Frame.cc ComputeStereoMatches), the disparity window
    # uR in [uL - maxD, uL + 3], and the octave band +-1 — small (N, K)
    # arithmetic (see module docstring for why this shape).
    dm = d + valid_penalty(l_valid)[:, None] + valid_penalty(r_valid)[None, :]
    neg_cd, ni = jax.lax.top_k(-dm, TOP_K)   # (N, K)
    cd = -neg_cd
    c_y = r_y[ni]
    c_x = r_x[ni]
    c_l = r_level[ni].astype(jnp.float32)
    r_row = 2.0 * scale_factors[l_level]
    dy = jnp.abs(c_y - l_y[:, None])
    du = l_x[:, None] - c_x                  # = disparity if matched
    dl = jnp.abs(c_l - l_level[:, None].astype(jnp.float32))
    max_d = bf / min_z
    pen = (
        jnp.maximum(dy - r_row[:, None], 0.0)
        + jnp.maximum(-3.0 - du, 0.0) + jnp.maximum(du - max_d, 0.0)
        + jnp.maximum(dl - 1.0, 0.0)
    ) * PEN
    cdp = cd + pen                            # (N, K)
    j = jnp.argmin(cdp, axis=1)
    best_idx = jnp.take_along_axis(ni, j[:, None], axis=1)[:, 0].astype(jnp.int32)
    best_dist = jnp.min(cdp, axis=1)
    matched = best_dist <= TH_HIGH  # (N,) — small 1-D bools are fine

    # --- sub-pixel refinement at the left keypoint's octave -----------------
    inv_scale = 1.0 / scale_factors
    uR0 = r_x[best_idx]
    scaled_uR = uR0 * inv_scale[l_level]  # right u at left's octave

    P = 2 * W_PATCH + 1
    S = 2 * L_SHIFT + 1

    safe_y = jnp.clip(l_yl, W_PATCH, l_pyr.shape[1] - W_PATCH - 1)
    safe_x = jnp.clip(l_xl, W_PATCH + L_SHIFT + 1, l_pyr.shape[2] - W_PATCH - L_SHIFT - 2)
    safe_ur = jnp.clip(scaled_uR, W_PATCH + L_SHIFT + 1, l_pyr.shape[2] - W_PATCH - L_SHIFT - 2)

    # Patch gathers: (a) ONE whole-row gather (major-axis take of contiguous
    # rows), then (b) per-keypoint column selection as a batched one-hot
    # matmul (arithmetic one-hot: no predicate intermediates).
    ur0 = jnp.round(safe_ur).astype(jnp.int32)
    WIN = P + 2 * L_SHIFT
    n_kp = n
    L_, H0, W0 = l_pyr.shape

    dy_off = jnp.arange(-W_PATCH, W_PATCH + 1, dtype=jnp.int32)
    row_idx = (l_level * H0 + safe_y)[:, None] + dy_off[None, :]      # (N, P)
    both = jnp.concatenate(
        [l_pyr.reshape(L_ * H0, W0), r_pyr.reshape(L_ * H0, W0)], axis=1
    )                                                                  # (L*H, 2W)
    rows = jnp.take(both, row_idx.reshape(-1), axis=0).reshape(n_kp, P, 2 * W0)
    rows_l = rows[:, :, :W0]
    rows_r = rows[:, :, W0:]

    col_l = (safe_x[:, None] + dy_off[None, :])                        # (N, P)
    oh_l = arithmetic_one_hot(col_l, W0).transpose(0, 2, 1)            # (N, W0, P)
    patch_l = jnp.einsum("npw,nwq->npq", rows_l, oh_l,
                         precision=jax.lax.Precision.HIGHEST)          # (N, P, P)
    dx_win = jnp.arange(-W_PATCH - L_SHIFT, W_PATCH + L_SHIFT + 1, dtype=jnp.int32)
    col_r = ur0[:, None] + dx_win[None, :]                             # (N, WIN)
    oh_r = arithmetic_one_hot(col_r, W0).transpose(0, 2, 1)            # (N, W0, WIN)
    win_r = jnp.einsum("npw,nwq->npq", rows_r, oh_r,
                       precision=jax.lax.Precision.HIGHEST)            # (N, P, WIN)
    patch_l = patch_l - patch_l[:, W_PATCH, W_PATCH][:, None, None]
    patch_r = jnp.stack(
        [win_r[:, :, s:s + P] for s in range(S)], axis=1
    )  # (N, S, P, P)
    patch_r = patch_r - patch_r[:, :, W_PATCH, W_PATCH][:, :, None, None]
    sads = jnp.sum(jnp.abs(patch_l[:, None] - patch_r), axis=(-1, -2))  # (N, S)

    k = jnp.argmin(sads, axis=1)
    ok_k = (k > 0) & (k < S - 1)
    km = jnp.clip(k, 1, S - 2)
    take = lambda off: jnp.take_along_axis(sads, (km + off)[:, None], axis=1)[:, 0]
    c1, c2, c3 = take(-1), take(0), take(1)
    denom = jnp.maximum(2.0 * (c1 + c3 - 2.0 * c2), 1e-6)
    delta = (c1 - c3) / denom
    ok_d = jnp.abs(delta) <= 1.0
    ur_ref = ur0.astype(jnp.float32) + (km - L_SHIFT).astype(jnp.float32) + delta
    sad_best = c2
    ok_ref = ok_k & ok_d

    # Back to level-0 coords; disparity & depth gates (Frame.cc:986-1004).
    u_right = ur_ref * scale_factors[l_level]
    disparity = l_x - u_right
    disparity_ok = (disparity > 0.01) & (disparity < max_d)
    u_right = jnp.where(disparity <= 0.01, l_x - 0.01, u_right)
    disparity = jnp.maximum(disparity, 0.01)
    depth = bf / disparity

    good = matched & ok_ref & disparity_ok

    # Median-distance cull (Frame.cc:1040-1063): drop matches whose refine
    # SAD exceeds 1.5 * 1.4 * median. Masked median via one sort; the mask
    # enters as an additive penalty, keeping the sort input pure-arithmetic.
    sad_pen = sad_best + (1.0 - good.astype(jnp.float32)) * BIG
    sad_sorted = jnp.sort(sad_pen)
    n_good = jnp.sum(good.astype(jnp.int32))
    med = sad_sorted[jnp.clip((n_good - 1) // 2, 0, n - 1)]
    med = jnp.where(n_good > 0, med, BIG)
    good = good & (sad_best <= 1.5 * 1.4 * med)

    return StereoMatches(
        jnp.where(good, u_right, -1.0),
        jnp.where(good, depth, -1.0),
        good,
    )


class FisheyeMatches(NamedTuple):
    idx_right: jnp.ndarray  # (N,) int32 best right index
    valid: jnp.ndarray      # (N,) bool (Lowe-ratio accepted)


@functools.partial(jax.jit, static_argnames=("ratio", "max_dist"))
def match_fisheye(
    l_desc: jnp.ndarray, l_valid: jnp.ndarray,
    r_desc: jnp.ndarray, r_valid: jnp.ndarray,
    ratio: float = 0.7,
    max_dist: int = TH_HIGH,
) -> FisheyeMatches:
    """Brute-force all-pairs Hamming + Lowe ratio
    (fisheyeStereoMatchKernel, StereoMatchKernel.cu:311-348). Geometry
    validation happens afterwards via cameras.triangulate_matches."""
    d = hamming_matrix_f32(l_desc, r_desc)
    dm = d + valid_penalty(l_valid)[:, None] + valid_penalty(r_valid)[None, :]
    # top-2 gives best AND second-best in one pass (no full-width knockout)
    neg2, ni2 = jax.lax.top_k(-dm, 2)
    best_idx = ni2[:, 0].astype(jnp.int32)
    best = -neg2[:, 0]
    second = -neg2[:, 1]
    ok = (best <= max_dist) & (best < ratio * second)
    return FisheyeMatches(best_idx, ok)
