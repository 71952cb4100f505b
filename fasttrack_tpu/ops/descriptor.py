"""Rotated-BRIEF (ORB) descriptors as one batched gather.

Parity target: src/descriptor.cu:20-89 (compute_descriptor_kernel): for each
keypoint, rotate the 256 sampling pairs by the IC angle, read the *blurred*
pyramid, compare each pair -> one bit; 32-byte descriptor.

Design: all N keypoints x 512 sample points become a single flat gather
into the (L*H*W) blurred tensor; the pack to 32 uint8 bytes is a matmul with
a power-of-two matrix. Descriptors are returned both as +-1 int8 vectors
(N, 256) — the Hamming-matmul format — and packed bytes (N, 32) for
storage/serialization parity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from fasttrack_tpu.ops.pattern import N_BITS, PATTERN


def brief_descriptors(
    blurred: jnp.ndarray,  # (L, H, W)
    x: jnp.ndarray,        # (N,) int32 level coords
    y: jnp.ndarray,        # (N,)
    level: jnp.ndarray,    # (N,)
    angle: jnp.ndarray,    # (N,) radians
) -> jnp.ndarray:
    """Returns bit matrix (N, 256) uint8 in {0, 1}."""
    L, H, W = blurred.shape
    flat = blurred.reshape(-1)
    pat = jnp.asarray(PATTERN, dtype=jnp.float32)  # (256, 2, 2) [.., (x, y)]
    px = pat[..., 0].reshape(-1)  # (512,)
    py = pat[..., 1].reshape(-1)

    ca, sa = jnp.cos(angle), jnp.sin(angle)  # (N,)
    # Rotate pattern points: (x', y') = (x ca - y sa, x sa + y ca), rounded
    # to nearest like the reference's cvRound sampling.
    rx = jnp.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None]).astype(jnp.int32)
    ry = jnp.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None]).astype(jnp.int32)
    gx = x[:, None] + rx  # (N, 512)
    gy = y[:, None] + ry
    gx = jnp.clip(gx, 0, W - 1)
    gy = jnp.clip(gy, 0, H - 1)
    idx = (level[:, None] * H + gy) * W + gx
    vals = jnp.take(flat, idx.reshape(-1), axis=0).reshape(idx.shape)  # (N, 512)
    a = vals[:, 0::2]
    b = vals[:, 1::2]
    return (a < b).astype(jnp.uint8)  # (N, 256)


# ---- patch-based descriptor path ------------------------------------------
#
# Rotation is quantized to N_ANGLE_BINS; per bin the rotated 512 sample
# points become a constant 0/1 sampling matrix over the flattened patch, so
# sampling ALL keypoints for ALL bins is a single bf16 matmul, and the
# per-keypoint bin select is a small gather. 22.5-degree bins cost <1 bit of
# extra Hamming noise vs continuous rotation (pattern points are rounded to
# integer pixels either way).

N_ANGLE_BINS = 16
PATCH_HALF_EXT = 20  # patch half-size: covers rotated samples (13*sqrt2<19)


def _binned_sampling_matrices() -> np.ndarray:
    """(N_ANGLE_BINS, 512, P*P) 0/1 sampling matrices over the flat patch."""
    P = 2 * PATCH_HALF_EXT + 1
    pat = PATTERN.reshape(-1, 2).astype(np.float64)  # (512, 2) [x, y]
    mats = np.zeros((N_ANGLE_BINS, 512, P * P), np.float32)
    for b in range(N_ANGLE_BINS):
        a = 2 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(a), np.sin(a)
        rx = np.round(pat[:, 0] * ca - pat[:, 1] * sa).astype(np.int64)
        ry = np.round(pat[:, 0] * sa + pat[:, 1] * ca).astype(np.int64)
        rx = np.clip(rx, -PATCH_HALF_EXT, PATCH_HALF_EXT)
        ry = np.clip(ry, -PATCH_HALF_EXT, PATCH_HALF_EXT)
        idx = (ry + PATCH_HALF_EXT) * P + (rx + PATCH_HALF_EXT)
        mats[b, np.arange(512), idx] = 1.0
    return mats


_SAMPLING = _binned_sampling_matrices()


def brief_from_patches(patches: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    """patches (N, P, P) blurred intensity, angle (N,) radians ->
    (N, 256) {0,1} bit matrix.

    ONE matmul (N, P*P) @ (P*P, A*512) computes the sampled values for
    every angle bin, then a take_along_axis picks each keypoint's bin.
    Operands are bf16 (0/1 sampling weights, intensities rounded to 8
    significant bits) with f32 sums."""
    n = patches.shape[0]
    flat = patches.reshape(n, -1).astype(jnp.bfloat16)          # (N, P*P)
    S = jnp.asarray(
        _SAMPLING.reshape(N_ANGLE_BINS * 512, -1).T, jnp.bfloat16
    )                                                            # (P*P, A*512)
    allbins = jax.lax.dot_general(
        flat, S, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32
    ).reshape(n, N_ANGLE_BINS, 512)                              # (N, A, 512)
    frac = (angle / (2 * jnp.pi)) % 1.0
    bins = jnp.clip(
        jnp.round(frac * N_ANGLE_BINS).astype(jnp.int32) % N_ANGLE_BINS,
        0,
        N_ANGLE_BINS - 1,
    )
    vals = jnp.take_along_axis(allbins, bins[:, None, None], axis=1)[:, 0]  # (N, 512)
    a = vals[:, 0::2]
    b = vals[:, 1::2]
    return (a < b).astype(jnp.uint8)


_POW2 = (2 ** np.arange(8, dtype=np.uint32)).astype(np.uint32)


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """(N, 256) {0,1} -> (N, 32) uint8 packed little-endian per byte."""
    n = bits.shape[0]
    b = bits.reshape(n, 32, 8).astype(jnp.uint32)
    return jnp.sum(b * jnp.asarray(_POW2)[None, None, :], axis=-1).astype(jnp.uint8)


def unpack_bits(packed: jnp.ndarray) -> jnp.ndarray:
    """(N, 32) uint8 -> (N, 256) {0,1} uint8."""
    n = packed.shape[0]
    b = packed.astype(jnp.uint32)[:, :, None]
    bits = (b >> jnp.arange(8, dtype=jnp.uint32)[None, None, :]) & 1
    return bits.reshape(n, 256).astype(jnp.uint8)
