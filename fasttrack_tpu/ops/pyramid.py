"""Image pyramid: bilinear resize + 7x7 Gaussian blur — as matmuls.

Parity targets: src/resize.cu:19-57 (bilinear pyramid, all levels in one 3-D
launch over a level-0-pitch buffer) and src/gaussian_blur.cu:17-54 (7x7
conv per level; KW=KH=7, SIGMA=2 — include/ORBextractor.h:33-35).

Design: levels live in ONE padded tensor (L, H0, W0) exactly like
the reference's `level*cols*rows` device layout (fast.cu:270), so FAST /
orientation / descriptor run as single fused ops across all levels.

Resize and blur are both LINEAR in the image, and separable by rows/columns,
so every level (raw and blurred) is computed as `A_l @ img @ B_l^T` with
per-level constant matrices that fold resize + blur + zero-padding into one
pair of batched matmuls, in place of a C=1 depthwise conv (the naive
translation of gaussian_blur.cu).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class PyramidConfig(NamedTuple):
    height: int
    width: int
    n_levels: int = 8
    scale_factor: float = 1.2

    @property
    def scales(self):
        return [self.scale_factor**l for l in range(self.n_levels)]

    @property
    def inv_scales(self):
        return [1.0 / s for s in self.scales]

    @property
    def level_sizes(self):
        """(h_l, w_l) per level, rounding like cv::resize."""
        return [
            (int(round(self.height / s)), int(round(self.width / s)))
            for s in self.scales
        ]

    def sigma2(self):
        """Per-level keypoint variance (ORBextractor mvLevelSigma2)."""
        return np.asarray(
            [self.scale_factor ** (2 * l) for l in range(self.n_levels)],
            dtype=np.float32,
        )


def gaussian_kernel_1d(size: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = np.arange(size) - (size - 1) / 2
    k = np.exp(-0.5 * (r / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) bilinear (align_corners=False) resampling matrix,
    matching jax.image.resize(method='bilinear') / cv::resize sampling:
    src = (dst + 0.5) * n_in/n_out - 0.5, clamped."""
    m = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        src = min(max(src, 0.0), n_in - 1.0)
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        f = src - lo
        m[i, lo] += 1.0 - f
        m[i, hi] += f
    return m


def _blur_matrix(n: int, size: int = 7, sigma: float = 2.0) -> np.ndarray:
    """(n, n) banded matrix of the 1-D Gaussian with replicate padding at
    the [0, n) boundary (the reference kernel clamps coordinates,
    gaussian_blur.cu:17-54)."""
    k = gaussian_kernel_1d(size, sigma).astype(np.float64)
    half = size // 2
    m = np.zeros((n, n), np.float64)
    for i in range(n):
        for t in range(size):
            j = min(max(i + t - half, 0), n - 1)
            m[i, j] += k[t]
    return m


@functools.lru_cache(maxsize=8)
def _pyramid_matrices_np(config: PyramidConfig):
    """Row/col operators (2L, H0, H0) / (2L, W0, W0): levels 0..L-1 are the
    raw resizes, levels L..2L-1 the resize+blur, each zero-padded to the
    level-0 canvas."""
    L = config.n_levels
    H0, W0 = config.height, config.width
    rows = np.zeros((2 * L, H0, H0), np.float32)
    cols = np.zeros((2 * L, W0, W0), np.float32)
    for l, (h, w) in enumerate(config.level_sizes):
        rh = _resize_matrix(h, H0)
        cw = _resize_matrix(w, W0)
        rows[l, :h, :] = rh
        cols[l, :w, :] = cw  # (w, W0)
        rows[L + l, :h, :] = _blur_matrix(h) @ rh
        cols[L + l, :w, :] = _blur_matrix(w) @ cw
    return rows, cols


class Pyramid(NamedTuple):
    """Padded pyramid tensors. Levels beyond (h_l, w_l) are zero."""

    raw: jnp.ndarray      # (L, H0, W0) float32, unblurred (FAST reads this)
    blurred: jnp.ndarray  # (L, H0, W0) float32 (descriptor reads this)
    # Static (python) metadata:
    config: PyramidConfig


def _apply_pyramid_ops(img: jnp.ndarray, config: PyramidConfig) -> jnp.ndarray:
    """img (H0, W0) -> (2L, H0, W0): raw levels then blurred levels."""
    rows_np, cols_np = _pyramid_matrices_np(config)
    rows = jnp.asarray(rows_np)
    cols = jnp.asarray(cols_np)
    # (2L, H0, H0) @ (H0, W0) -> (2L, H0, W0)   [batched row resample+blur]
    # precision DEFAULT (TF32 on the GPU, ~3 decimal digits): gray values
    # are 0-255 and the rounding stays far below FAST's threshold; this
    # pair of matmuls is most of the extraction FLOPs (the package pins f32
    # matmuls to HIGHEST globally, __init__.py).
    tmp = jax.lax.dot_general(
        rows, img, (((2,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    )
    # (2L, H0, W0) @ (2L, W0, W0)^T -> (2L, H0, W0)  [batched col pass]
    out = jax.lax.dot_general(
        tmp, cols, (((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    )
    return out


@functools.partial(jax.jit, static_argnames=("config",))
def build_pyramid(image: jnp.ndarray, config: PyramidConfig) -> Pyramid:
    """image (H, W) uint8/float -> Pyramid.

    Each level is resized from level 0 directly (better than chained
    downsampling; the reference chains from the previous level which
    compounds bilinear softening).
    """
    img = image.astype(jnp.float32)
    L = config.n_levels
    both = _apply_pyramid_ops(img, config)
    return Pyramid(both[:L], both[L:], config)


def build_pyramid_pair(
    image_left: jnp.ndarray, image_right: jnp.ndarray, config: PyramidConfig
):
    """Both stereo cameras in one batched matmul pair.

    Returns (raw2, blur2), each (2L, H0, W0) with camera 0 levels first —
    the layout extract_orb_pair consumes.
    """
    L = config.n_levels
    imgs = jnp.stack(
        [image_left.astype(jnp.float32), image_right.astype(jnp.float32)]
    )  # (2, H0, W0)
    rows_np, cols_np = _pyramid_matrices_np(config)
    rows = jnp.asarray(rows_np)  # (2L, H0, H0)
    cols = jnp.asarray(cols_np)  # (2L, W0, W0)
    # (2L, H0, H0) x (2, H0, W0) -> (2L, 2, H0, W0)
    tmp = jnp.einsum(
        "lhH,cHW->lchW", rows, imgs, preferred_element_type=jnp.float32
    )
    out = jnp.einsum(
        "lchW,lwW->lchw", tmp, cols, preferred_element_type=jnp.float32
    )  # (2L, 2, H0, W0)
    raw = out[:L]      # (L, 2, H0, W0)
    blur = out[L:]
    raw2 = jnp.concatenate([raw[:, 0], raw[:, 1]], axis=0)    # (2L, H0, W0)
    blur2 = jnp.concatenate([blur[:, 0], blur[:, 1]], axis=0)
    return raw2, blur2


@functools.lru_cache(maxsize=8)
def _valid_mask_np(config: PyramidConfig) -> np.ndarray:
    m = np.zeros((config.n_levels, config.height, config.width), dtype=np.float32)
    for l, (h, w) in enumerate(config.level_sizes):
        m[l, :h, :w] = 1.0
    return m


def level_valid_mask(config: PyramidConfig) -> jnp.ndarray:
    return jnp.asarray(_valid_mask_np(config))
