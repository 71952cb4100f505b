"""Keypoint orientation: intensity-centroid (IC) angle.

Parity target: src/orientation.cu:20-87 (compute_orientation_kernel) /
ORBextractor.cc IC_Angle — moments m10, m01 over a radius-15 circular patch
on the *raw* pyramid level, angle = atan2(m01, m10).

Design: one (31, 31) dynamic-slice gather per keypoint, vmapped over the
padded keypoint set; the circular mask and coordinate grids are constants
folded into the kernel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

HALF_PATCH = 15


def _circle_mask() -> np.ndarray:
    d = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    dy, dx = np.meshgrid(d, d, indexing="ij")
    # Matches ORB's u_max table: |dx| <= round(sqrt(r^2 - dy^2)).
    umax = np.round(np.sqrt(np.maximum(HALF_PATCH**2 - d.astype(np.float64) ** 2, 0.0)))
    return (np.abs(dx) <= umax[dy + HALF_PATCH]).astype(np.float32)


_MASK = _circle_mask()
_D = np.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=np.float32)
_DY, _DX = np.meshgrid(_D, _D, indexing="ij")


def extract_patches(
    levels: jnp.ndarray,   # (L, H, W)
    x: jnp.ndarray,        # (N,) int32 level coords
    y: jnp.ndarray,
    level: jnp.ndarray,
    half: int,
) -> jnp.ndarray:
    """(N, 2*half+1, 2*half+1) patches via vmapped dynamic_slice."""
    P = 2 * half + 1

    def one(li, yi, xi):
        return jax.lax.dynamic_slice(levels, (li, yi - half, xi - half), (1, P, P))[0]

    return jax.vmap(one)(level, y, x)


def _moment_weights(patch_size: int) -> np.ndarray:
    """(P*P, 2) weights: flat-patch inner product -> (m10, m01). The 31x31
    circular moment window is embedded centered in the P x P patch."""
    ph = patch_size // 2
    wx = np.zeros((patch_size, patch_size), np.float32)
    wy = np.zeros((patch_size, patch_size), np.float32)
    lo = ph - HALF_PATCH
    hi = ph + HALF_PATCH + 1
    wx[lo:hi, lo:hi] = _DX * _MASK
    wy[lo:hi, lo:hi] = _DY * _MASK
    return np.stack([wx.reshape(-1), wy.reshape(-1)], axis=1)


@functools.lru_cache(maxsize=None)
def _moment_weights_np(patch_size: int) -> np.ndarray:
    # Cache the NumPy constant only — caching a jnp array would leak tracers
    # across jit scopes; jnp.asarray of a constant folds inside each jit.
    return _moment_weights(patch_size)


def ic_angles_from_patches(patches: jnp.ndarray) -> jnp.ndarray:
    """IC angle from pre-gathered patches with center at the middle; the
    patch may be larger than the 31x31 moment window. ONE (N, P*P) @ (P*P, 2)
    matmul (float32: moments are sums of ~700 pixel values — bf16 would
    cost ~3 bits of mantissa and visibly perturb angles)."""
    n, P, _ = patches.shape
    w = jnp.asarray(_moment_weights_np(P))
    m = jax.lax.dot_general(
        patches.reshape(n, -1), w, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (N, 2) = (m10, m01)
    return jnp.arctan2(m[:, 1], m[:, 0])


def ic_angles(
    levels: jnp.ndarray,   # (L, H, W) raw pyramid
    x: jnp.ndarray,        # (N,) int32 level coords
    y: jnp.ndarray,        # (N,)
    level: jnp.ndarray,    # (N,) int32
) -> jnp.ndarray:
    """Returns angles in radians, (N,). Caller guarantees the patch is in
    bounds (border >= 16 > HALF_PATCH)."""
    mask = jnp.asarray(_MASK)
    dxw = jnp.asarray(_DX) * mask
    dyw = jnp.asarray(_DY) * mask

    def one(xi, yi, li):
        patch = jax.lax.dynamic_slice(
            levels,
            (li, yi - HALF_PATCH, xi - HALF_PATCH),
            (1, 2 * HALF_PATCH + 1, 2 * HALF_PATCH + 1),
        )[0]
        m10 = jnp.sum(patch * dxw)
        m01 = jnp.sum(patch * dyw)
        return jnp.arctan2(m01, m10)

    return jax.vmap(one)(x, y, level)
