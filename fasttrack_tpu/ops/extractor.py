"""ORB extraction pipeline: pyramid -> FAST -> IC angle -> rotated BRIEF.

Parity target: ORBextractor::operator() GPU route (ORBextractor.cc:1356-1445:
ComputePyramidGPU :1522, ComputeKeyPointsOctTreeGPU :1229, descriptor pass,
then scale coords to level 0). The whole extraction is ONE jitted function;
keypoints, descriptors and the pyramid stay device-resident for the later
stereo-match / search kernels, mirroring the reference's GPU residency
(KernelController.cu:100-117).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fasttrack_tpu.ops.descriptor import brief_descriptors, pack_bits
from fasttrack_tpu.ops.fast import FastConfig, fast_detect
from fasttrack_tpu.ops.hamming import signed_descriptors
from fasttrack_tpu.ops.orientation import ic_angles
from fasttrack_tpu.ops.pyramid import Pyramid, PyramidConfig, build_pyramid


class OrbConfig(NamedTuple):
    height: int = 480
    width: int = 752
    n_features: int = 1024
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_threshold: float = 20.0
    min_threshold: float = 7.0

    @property
    def pyramid(self) -> PyramidConfig:
        return PyramidConfig(self.height, self.width, self.n_levels, self.scale_factor)

    @property
    def fast(self) -> FastConfig:
        return FastConfig(self.ini_threshold, self.min_threshold)

    @functools.lru_cache(maxsize=None)
    def per_level_features(self) -> tuple:
        """Geometric feature budget per level (ORBextractor ctor:
        nDesiredFeaturesPerScale with factor 1/scale)."""
        factor = 1.0 / self.scale_factor
        n0 = self.n_features * (1 - factor) / (1 - factor**self.n_levels)
        ks = []
        acc = 0
        for l in range(self.n_levels - 1):
            k = int(round(n0 * factor**l))
            ks.append(k)
            acc += k
        ks.append(max(self.n_features - acc, 0))
        return tuple(ks)

    @property
    def total_features(self) -> int:
        return sum(self.per_level_features())


class Keypoints(NamedTuple):
    """Padded, fixed-capacity keypoint set (device-resident frame state)."""

    x: jnp.ndarray        # (N,) float32, level-0 coords
    y: jnp.ndarray        # (N,)
    xl: jnp.ndarray       # (N,) int32, native level coords
    yl: jnp.ndarray       # (N,) int32
    level: jnp.ndarray    # (N,) int32 octave
    angle: jnp.ndarray    # (N,) float32 radians
    score: jnp.ndarray    # (N,) float32 FAST score
    desc_signed: jnp.ndarray  # (N, 256) int8 +-1 — the Hamming-matmul format
    desc_packed: jnp.ndarray  # (N, 32) uint8 — storage format
    valid: jnp.ndarray    # (N,) bool

    @property
    def capacity(self) -> int:
        return self.x.shape[0]


@functools.partial(jax.jit, static_argnames=("config",))
def extract_orb(image: jnp.ndarray, config: OrbConfig):
    """image (H, W) -> (Keypoints, Pyramid). Fully device-resident."""
    pcfg = config.pyramid
    pyr = build_pyramid(image, pcfg)
    per_level = config.per_level_features()
    fk = fast_detect(
        pyr.raw, tuple(pcfg.level_sizes), per_level, config.fast
    )
    # Flatten per-level (L, K) slots into one (N,) set with static slices.
    xs, ys, lv, sc, va = [], [], [], [], []
    for l, k in enumerate(per_level):
        xs.append(fk.x[l, :k])
        ys.append(fk.y[l, :k])
        lv.append(jnp.full((k,), l, dtype=jnp.int32))
        sc.append(fk.score[l, :k])
        va.append(fk.valid[l, :k])
    xl = jnp.concatenate(xs)
    yl = jnp.concatenate(ys)
    level = jnp.concatenate(lv)
    score = jnp.concatenate(sc)
    valid = jnp.concatenate(va)

    # Clamp invalid slots to a safe in-bounds location for the gathers.
    from fasttrack_tpu.ops.descriptor import PATCH_HALF_EXT, brief_from_patches
    from fasttrack_tpu.ops.orientation import (
        extract_patches,
        ic_angles_from_patches,
    )

    ph = PATCH_HALF_EXT
    safe_x = jnp.where(valid, jnp.clip(xl, ph, pcfg.width - ph - 1), ph)
    safe_y = jnp.where(valid, jnp.clip(yl, ph, pcfg.height - ph - 1), ph)

    # ONE patch gather per keypoint feeds IC-angle, BRIEF sampling, and the
    # stereo sub-pixel refinement (persistent device residency, the
    # reference's KernelController.cu:100-117 idea taken further).
    patches = extract_patches(pyr.blurred, safe_x, safe_y, level, ph)
    angle = ic_angles_from_patches(patches)
    bits = brief_from_patches(patches, angle)
    bits = bits * valid[:, None].astype(bits.dtype)
    scales = jnp.asarray(
        [config.scale_factor**l for l in range(config.n_levels)], dtype=jnp.float32
    )
    s = scales[level]
    kps = Keypoints(
        x=xl.astype(jnp.float32) * s,
        y=yl.astype(jnp.float32) * s,
        xl=xl,
        yl=yl,
        level=level,
        angle=angle,
        score=score,
        desc_signed=signed_descriptors(bits),
        desc_packed=pack_bits(bits),
        valid=valid,
    )
    return kps, pyr


@functools.partial(jax.jit, static_argnames=("config",))
def extract_orb_pair(image_left: jnp.ndarray, image_right: jnp.ndarray,
                     config: OrbConfig):
    """Extract ORB for BOTH stereo images in one flat pipeline.

    The pyramids are stacked into a (2L, H, W) level tensor so FAST,
    patch-gather, IC-angle and BRIEF all run once over 2N keypoints
    rather than under an outer vmap over cameras.
    Returns (kps_left, kps_right, pyr_left, pyr_right).
    """
    from fasttrack_tpu.ops.descriptor import PATCH_HALF_EXT, brief_from_patches
    from fasttrack_tpu.ops.orientation import extract_patches, ic_angles_from_patches

    from fasttrack_tpu.ops.pyramid import Pyramid, build_pyramid_pair

    pcfg = config.pyramid
    L = pcfg.n_levels
    # Accept uint8 frames: upload 1 byte/px (4x less transfer than float32)
    # and widen on device.
    image_left = image_left.astype(jnp.float32)
    image_right = image_right.astype(jnp.float32)
    raw2, blur2 = build_pyramid_pair(image_left, image_right, pcfg)  # (2L, H, W)
    pyr_l = Pyramid(raw2[:L], blur2[:L], pcfg)
    pyr_r = Pyramid(raw2[L:], blur2[L:], pcfg)

    per_level = config.per_level_features()
    sizes2 = tuple(pcfg.level_sizes) * 2
    per_level2 = per_level * 2
    fk = fast_detect(raw2, sizes2, per_level2, config.fast)

    xs, ys, lv, sc, va = [], [], [], [], []
    for l2 in range(2 * L):
        k = per_level2[l2]
        xs.append(fk.x[l2, :k])
        ys.append(fk.y[l2, :k])
        lv.append(jnp.full((k,), l2, dtype=jnp.int32))  # absolute level idx
        sc.append(fk.score[l2, :k])
        va.append(fk.valid[l2, :k])
    xl = jnp.concatenate(xs)
    yl = jnp.concatenate(ys)
    lvl2 = jnp.concatenate(lv)
    score = jnp.concatenate(sc)
    valid = jnp.concatenate(va)

    ph = PATCH_HALF_EXT
    safe_x = jnp.where(valid, jnp.clip(xl, ph, pcfg.width - ph - 1), ph)
    safe_y = jnp.where(valid, jnp.clip(yl, ph, pcfg.height - ph - 1), ph)
    patches = extract_patches(blur2, safe_x, safe_y, lvl2, ph)
    angle = ic_angles_from_patches(patches)
    bits = brief_from_patches(patches, angle)
    bits = bits * valid[:, None].astype(bits.dtype)
    signed = signed_descriptors(bits)
    packed = pack_bits(bits)

    scales = jnp.asarray(
        [config.scale_factor**l for l in range(L)], dtype=jnp.float32
    )
    level = lvl2 % L
    s = scales[level]

    n = config.total_features
    def cam_slice(a, c):
        return a[c * n:(c + 1) * n]

    out = []
    for c in range(2):
        out.append(Keypoints(
            x=cam_slice(xl, c).astype(jnp.float32) * cam_slice(s, c),
            y=cam_slice(yl, c).astype(jnp.float32) * cam_slice(s, c),
            xl=cam_slice(xl, c),
            yl=cam_slice(yl, c),
            level=cam_slice(level, c),
            angle=cam_slice(angle, c),
            score=cam_slice(score, c),
            desc_signed=cam_slice(signed, c),
            desc_packed=cam_slice(packed, c),
            valid=cam_slice(valid, c),
        ))
    return out[0], out[1], pyr_l, pyr_r


@functools.partial(jax.jit, static_argnames=("config",))
def extract_orb_pair_stacked(images: jnp.ndarray, config: OrbConfig):
    """extract_orb_pair on a stacked (2, H, W) image tensor.

    The stacked form lets the caller upload BOTH camera images in ONE
    host->device transfer."""
    return extract_orb_pair(images[0], images[1], config)


def make_extract_fn(config: OrbConfig):
    """Returns a jitted image -> (Keypoints, Pyramid) closure."""

    def fn(image):
        return extract_orb(image, config)

    return jax.jit(fn)
