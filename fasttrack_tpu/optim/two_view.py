"""Monocular two-view reconstruction: batched H/F RANSAC + model selection.

Parity target: src/TwoViewReconstruction.cc — the reference runs homography
and fundamental RANSAC in two parallel std::threads (:105-106), scores with
truncated symmetric transfer chi2 (CheckHomography/CheckFundamental),
selects H when SH/(SH+SF) > 0.4, then reconstructs R,t by testing all
decompositions with a triangulation census (ReconstructH/ReconstructF,
CheckRT :475-901).

Design: instead of two threads iterating 200 hypotheses each, ALL
hypotheses for BOTH models are solved as one batched SVD and scored against
all correspondences in one einsum — RANSAC becomes a data-parallel argmax.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fasttrack_tpu.geometry.so3 import hat

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # the reference adds (TH - chi2) with TH=5.991 for both


def _normalize_pts(x):
    """Hartley normalization; returns (x_norm, T) with T (3,3)."""
    mean = jnp.mean(x, axis=0)
    d = jnp.mean(jnp.linalg.norm(x - mean, axis=1))
    s = jnp.sqrt(2.0) / jnp.maximum(d, 1e-9)
    T = jnp.array(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=x.dtype
    ) * s
    T = T.at[0, 2].set(-s * mean[0])
    T = T.at[1, 2].set(-s * mean[1])
    T = T.at[2, 2].set(1.0)
    xn = (x - mean) * s
    return xn, T


def _solve_h_batch(p1, p2):
    """p1, p2: (M, 4, 2) minimal sets -> (M, 3, 3) homographies (DLT)."""
    M = p1.shape[0]
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    r1 = jnp.stack([x, y, o, z, z, z, -u * x, -u * y, -u], axis=-1)
    r2 = jnp.stack([z, z, z, x, y, o, -v * x, -v * y, -v], axis=-1)
    A = jnp.concatenate([r1, r2], axis=1)  # (M, 8, 9)
    _, _, vt = jnp.linalg.svd(A)
    return vt[:, -1, :].reshape(M, 3, 3)


def _solve_f_batch(p1, p2):
    """p1, p2: (M, 8, 2) minimal sets -> (M, 3, 3) rank-2 fundamentals."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    o = jnp.ones_like(x)
    A = jnp.stack([u * x, u * y, u, v * x, v * y, v, x, y, o], axis=-1)  # (M,8,9)
    _, _, vt = jnp.linalg.svd(A)
    F = vt[:, -1, :].reshape(-1, 3, 3)
    # enforce rank 2
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[:, 2].set(0.0)
    return U @ (S[..., None] * Vt)


def _score_h(H, p1, p2, sigma2):
    """Symmetric transfer score over all points: (M,) score, (M, N) inlier."""
    def transfer(Hm, a, b):
        ah = jnp.concatenate([a, jnp.ones((*a.shape[:-1], 1), a.dtype)], -1)
        pr = ah @ Hm.T  # broadcasting (M?,N,3)
        w = pr[..., 2:3]
        pr = pr[..., :2] / jnp.where(jnp.abs(w) < 1e-9, 1e-9, w)
        return jnp.sum((pr - b) ** 2, axis=-1) / sigma2

    e12 = jax.vmap(lambda Hm: transfer(Hm, p1, p2))(H)  # (M, N)
    Hinv = jnp.linalg.inv(H)
    e21 = jax.vmap(lambda Hm: transfer(Hm, p2, p1))(Hinv)
    ok = (e12 < CHI2_H) & (e21 < CHI2_H)
    score = jnp.sum(
        jnp.where(e12 < CHI2_H, SCORE_TH - e12, 0.0)
        + jnp.where(e21 < CHI2_H, SCORE_TH - e21, 0.0),
        axis=-1,
    )
    return score, ok


def _score_f(F, p1, p2, sigma2):
    o = jnp.ones((p1.shape[0], 1), p1.dtype)
    x1 = jnp.concatenate([p1, o], -1)  # (N, 3)
    x2 = jnp.concatenate([p2, o], -1)
    l2 = jnp.einsum("mij,nj->mni", F, x1)          # epiline in img2
    l1 = jnp.einsum("mji,nj->mni", F, x2)          # epiline in img1
    num = jnp.einsum("ni,mni->mn", x2, l2)
    d2 = num**2 / jnp.maximum(l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12) / sigma2
    num1 = jnp.einsum("ni,mni->mn", x1, l1)
    d1 = num1**2 / jnp.maximum(l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12) / sigma2
    ok = (d1 < CHI2_F) & (d2 < CHI2_F)
    score = jnp.sum(
        jnp.where(d2 < CHI2_F, SCORE_TH - d2, 0.0)
        + jnp.where(d1 < CHI2_F, SCORE_TH - d1, 0.0),
        axis=-1,
    )
    return score, ok


def _triangulate_census(R, t, K, p1, p2, valid, sigma2, parallax_min=0.99998):
    """CheckRT (TwoViewReconstruction.cc:475): triangulate all points for a
    candidate (R, t), count good (finite, in front of both cams, low reproj
    error, enough parallax). Returns (n_good, good_mask, X, parallax_ok)."""
    Kinv = jnp.linalg.inv(K)
    o = jnp.ones((p1.shape[0], 1), p1.dtype)
    r1 = (jnp.concatenate([p1, o], -1) @ Kinv.T)
    r2 = (jnp.concatenate([p2, o], -1) @ Kinv.T)
    # DLT triangulation with P1=[I|0], P2=[R|t]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=p1.dtype), (p1.shape[0], 3, 3))
    P1 = jnp.concatenate([eye, jnp.zeros((p1.shape[0], 3, 1), p1.dtype)], -1)
    P2 = jnp.broadcast_to(
        jnp.concatenate([R, t[:, None]], -1), (p1.shape[0], 3, 4)
    )

    def rows(r, P):
        a = r[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        b = r[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return jnp.stack([a, b], -2)

    A = jnp.concatenate([rows(r1, P1), rows(r2, P2)], -2)
    _, _, vt = jnp.linalg.svd(A)
    Xh = vt[..., 3, :]
    X = Xh[..., :3] / jnp.where(jnp.abs(Xh[..., 3:]) < 1e-12, 1e-12, Xh[..., 3:])
    z1 = X[..., 2]
    X2 = X @ R.T + t
    z2 = X2[..., 2]
    # parallax between rays
    n1 = X / jnp.maximum(jnp.linalg.norm(X, axis=-1, keepdims=True), 1e-9)
    C2 = -R.T @ t
    d2v = X - C2
    n2 = d2v / jnp.maximum(jnp.linalg.norm(d2v, axis=-1, keepdims=True), 1e-9)
    cosp = jnp.sum(n1 * n2, axis=-1)
    # reprojection
    pr1 = X @ K.T
    pr1 = pr1[..., :2] / jnp.maximum(pr1[..., 2:], 1e-9)
    pr2 = X2 @ K.T
    pr2 = pr2[..., :2] / jnp.maximum(pr2[..., 2:], 1e-9)
    e1 = jnp.sum((pr1 - p1) ** 2, -1) / sigma2
    e2 = jnp.sum((pr2 - p2) ** 2, -1) / sigma2
    good = (
        valid & (z1 > 0) & (z2 > 0) & (cosp < parallax_min)
        & (e1 < 4 * CHI2_H) & (e2 < 4 * CHI2_H) & jnp.isfinite(X).all(-1)
    )
    return jnp.sum(good.astype(jnp.int32)), good, X, cosp


class TwoViewResult(NamedTuple):
    success: bool
    R: np.ndarray
    t: np.ndarray
    points3d: np.ndarray
    good_mask: np.ndarray
    used_homography: bool


def reconstruct_two_view(
    p1: np.ndarray,   # (N, 2) pixel coords, frame 1
    p2: np.ndarray,   # (N, 2) matched pixel coords, frame 2
    K: np.ndarray,    # (3, 3) intrinsics
    valid: np.ndarray | None = None,
    n_hypotheses: int = 256,
    sigma: float = 1.0,
    min_triangulated: int = 50,
    seed: int = 0,
) -> TwoViewResult:
    """Full two-view init. Host orchestration, device-batched math."""
    N = len(p1)
    if valid is None:
        valid = np.ones(N, bool)
    idx_pool = np.where(valid)[0]
    if len(idx_pool) < 20:
        return TwoViewResult(False, np.eye(3), np.zeros(3), np.zeros((N, 3)),
                             np.zeros(N, bool), False)
    rng = np.random.default_rng(seed)
    sigma2 = sigma * sigma

    p1j = jnp.asarray(p1, jnp.float32)
    p2j = jnp.asarray(p2, jnp.float32)
    vj = jnp.asarray(valid)

    # Hartley normalization (solve in normalized coords, score in pixels) —
    # unnormalized pixel DLT loses ~2 digits of model accuracy.
    p1n, T1 = _normalize_pts(p1j[jnp.asarray(idx_pool)])
    p2n, T2 = _normalize_pts(p2j[jnp.asarray(idx_pool)])
    mean1 = jnp.mean(p1j[jnp.asarray(idx_pool)], axis=0)
    mean2 = jnp.mean(p2j[jnp.asarray(idx_pool)], axis=0)
    s1, s2 = T1[0, 0], T2[0, 0]
    p1_all_n = (p1j - mean1) * s1
    p2_all_n = (p2j - mean2) * s2

    # Hypothesis minimal sets.
    sets_h = idx_pool[rng.integers(0, len(idx_pool), size=(n_hypotheses, 4))]
    sets_f = idx_pool[rng.integers(0, len(idx_pool), size=(n_hypotheses, 8))]

    Hn = _solve_h_batch(p1_all_n[sets_h], p2_all_n[sets_h])
    Fn = _solve_f_batch(p1_all_n[sets_f], p2_all_n[sets_f])
    # Denormalize: H = T2^-1 Hn T1 ; F = T2^T Fn T1.
    T1j = jnp.asarray(T1)
    T2inv = jnp.linalg.inv(jnp.asarray(T2))
    Hs = T2inv[None] @ Hn @ T1j[None]
    Fs = jnp.swapaxes(jnp.asarray(T2), 0, 1)[None] @ Fn @ T1j[None]
    sh, ok_h = _score_h(Hs, p1j, p2j, sigma2)
    sf, ok_f = _score_f(Fs, p1j, p2j, sigma2)
    sh = jnp.where(jnp.isfinite(sh), sh, -jnp.inf)
    sf = jnp.where(jnp.isfinite(sf), sf, -jnp.inf)
    # mask scores by validity of points
    bi_h = int(jnp.argmax(sh))
    bi_f = int(jnp.argmax(sf))
    SH = float(sh[bi_h])
    SF = float(sf[bi_f])
    ratio = SH / max(SH + SF, 1e-9)
    use_h = ratio > 0.4  # TwoViewReconstruction.cc model selection

    Kj = jnp.asarray(K, jnp.float32)
    if use_h:
        inl = np.asarray(ok_h[bi_h]) & valid
        # Least-squares refit on all inliers (normalized coords).
        ii = jnp.asarray(np.where(inl)[0])
        Hn_ref = _solve_h_batch(p1_all_n[ii][None], p2_all_n[ii][None])[0]
        H_ref = T2inv @ Hn_ref @ T1j
        sc, ok2 = _score_h(H_ref[None], p1j, p2j, sigma2)
        if float(sc[0]) >= SH:
            inl = np.asarray(ok2[0]) & valid
            cands = _decompose_homography(np.asarray(H_ref), K)
        else:
            cands = _decompose_homography(np.asarray(Hs[bi_h]), K)
    else:
        inl = np.asarray(ok_f[bi_f]) & valid
        ii = jnp.asarray(np.where(inl)[0])
        Fn_ref = _solve_f_batch(p1_all_n[ii][None], p2_all_n[ii][None])[0]
        F_ref = jnp.swapaxes(jnp.asarray(T2), 0, 1) @ Fn_ref @ T1j
        sc, ok2 = _score_f(F_ref[None], p1j, p2j, sigma2)
        if float(sc[0]) >= SF:
            inl = np.asarray(ok2[0]) & valid
            cands = _decompose_fundamental(np.asarray(F_ref), K)
        else:
            cands = _decompose_fundamental(np.asarray(Fs[bi_f]), K)

    best = None
    inlj = jnp.asarray(inl)
    for (R, t) in cands:
        n_good, good, X, cosp = _triangulate_census(
            jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32), Kj,
            p1j, p2j, inlj, sigma2,
        )
        n_good = int(n_good)
        if best is None or n_good > best[0]:
            best = (n_good, R, t, np.asarray(X), np.asarray(good),
                    np.asarray(cosp))
    n_good, R, t, X, good, cosp = best
    # CheckRT acceptance: clear winner, enough points, AND real parallax —
    # the reference's minParallax=1.0 deg gate on the 50th-largest-parallax
    # good point (TwoViewReconstruction.cc:510-517, ReconstructH/F minimum
    # parallax). Without it, pure-rotation footage builds a degenerate map
    # out of triangulation noise and poisons the whole session.
    if n_good > 0:
        cos_sorted = np.sort(cosp[good])         # ascending cos
        idx = min(50, n_good - 1)
        parallax_deg = float(np.degrees(np.arccos(
            np.clip(cos_sorted[idx], -1.0, 1.0)
        )))
    else:
        parallax_deg = 0.0
    success = (n_good >= min_triangulated and n_good > 0.7 * inl.sum()
               and parallax_deg > 1.0)
    tn = t / max(np.linalg.norm(t), 1e-12)
    return TwoViewResult(bool(success), R, tn, X, good, bool(use_h))


def _decompose_fundamental(F, K):
    """E = K^T F K -> 4 (R, t) candidates."""
    E = K.T @ F @ K
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / max(np.linalg.norm(t), 1e-12)
    return [(R1, t), (R1, -t), (R2, t), (R2, -t)]


def _decompose_homography(H, K):
    """Faugeras SVD decomposition of a calibrated homography -> 8 (R, t)
    candidates (TwoViewReconstruction::ReconstructH)."""
    A = np.linalg.inv(K) @ H @ K
    U, S, Vt = np.linalg.svd(A)
    s = np.linalg.det(U) * np.linalg.det(Vt)
    d1, d2, d3 = S
    if d1 / d2 < 1.0001 or d2 / d3 < 1.0001:
        # near-degenerate (pure rotation); return identity-rotation options
        return [(U @ Vt * np.sign(np.linalg.det(U @ Vt)), np.array([0, 0, 1e-6]))]
    cands = []
    aux1 = np.sqrt((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3))
    aux3 = np.sqrt((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3))
    x1s = [aux1, aux1, -aux1, -aux1]
    x3s = [aux3, -aux3, aux3, -aux3]
    # d' > 0
    aux_st = np.sqrt((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)) / ((d1 + d3) * d2)
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
    sts = [aux_st, -aux_st, -aux_st, aux_st]
    for i in range(4):
        Rp = np.array([[ct, 0, -sts[i]], [0, 1, 0], [sts[i], 0, ct]])
        tp = (d1 - d3) * np.array([x1s[i], 0, -x3s[i]])
        R = s * U @ Rp @ Vt
        t = U @ tp
        cands.append((R, t / max(np.linalg.norm(t), 1e-12)))
    # d' < 0
    aux_sp = np.sqrt((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)) / ((d1 - d3) * d2)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2)
    sps = [aux_sp, -aux_sp, -aux_sp, aux_sp]
    for i in range(4):
        Rp = np.array([[cp, 0, sps[i]], [0, -1, 0], [sps[i], 0, -cp]])
        tp = (d1 + d3) * np.array([x1s[i], 0, x3s[i]])
        R = s * U @ Rp @ Vt
        t = U @ tp
        cands.append((R, t / max(np.linalg.norm(t), 1e-12)))
    return cands
