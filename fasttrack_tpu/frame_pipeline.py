"""The per-frame front-end: images -> device-resident FrameData.

Stage functions are individually jitted; the orchestration is Python.
Extraction, stereo matching and search+optimize are separate programs
rather than one mega-jit of the whole frame (XLA fused the patch gathers
with the upstream pyramid badly when they were one program).

There are no eager jnp ops between the jitted stages: each eager op is its
own XLA program and dispatch. Every stack/concat/sum lives inside one of
the stage programs.

Parity target: the Frame constructor hot path (Frame.cc:115-170): parallel
L/R ORB extraction (two std::threads, Frame.cc:127-130) + GPU stereo matching
(ComputeStereoMatchesGPU, Frame.cc:1007-1063) + grid assignment.

Design: the two cameras are one batched extraction over a (2, H, W)
tensor (in place of the reference's two threads + three CUDA streams), and
the whole FrameData stays device-resident for the subsequent search/pose
kernels (the reference's persistent GPU residency,
KernelController.cu:100-117). The 64x48 feature grid of the reference
exists only to accelerate windowed search; the dense Hamming-matmul matcher
needs no grid, so none is built.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from fasttrack_tpu.ops.extractor import Keypoints, OrbConfig, extract_orb
from fasttrack_tpu.ops.stereo_match import StereoMatches, match_rectified


class FrameData(NamedTuple):
    """Device-resident arrays for one stereo (or mono) frame."""

    kps: Keypoints          # left-camera keypoints
    kps_right: Keypoints | None
    u_right: jnp.ndarray    # (N,) float32; -1 = no stereo depth
    depth: jnp.ndarray      # (N,) float32; -1 = none
    n_valid: jnp.ndarray    # () int32


@functools.partial(jax.jit, static_argnames=("config",))
def process_mono_frame(image: jnp.ndarray, config: OrbConfig) -> FrameData:
    kps, _ = extract_orb(image, config)
    n = kps.capacity
    neg = jnp.full((n,), -1.0)
    return FrameData(kps, None, neg, neg, jnp.sum(kps.valid.astype(jnp.int32)))


@functools.partial(jax.jit, static_argnames=("config",))
def process_rgbd_frame(
    image: jnp.ndarray,
    depth_map: jnp.ndarray,   # (H, W) metric depth, <=0 invalid
    config: OrbConfig,
    bf: jnp.ndarray,
) -> FrameData:
    """RGB-D frame (Frame.cc RGBD ctor): mono extraction + depth lookup at
    keypoint locations; synthetic right coordinate u_r = u - bf/z."""
    kps, _ = extract_orb(image, config)
    xi = jnp.clip(kps.x.astype(jnp.int32), 0, config.width - 1)
    yi = jnp.clip(kps.y.astype(jnp.int32), 0, config.height - 1)
    z = depth_map[yi, xi]
    has_depth = kps.valid & (z > 0)
    u_right = jnp.where(has_depth, kps.x - bf / jnp.maximum(z, 1e-6), -1.0)
    depth = jnp.where(has_depth, z, -1.0)
    return FrameData(kps, None, u_right, depth, jnp.sum(kps.valid.astype(jnp.int32)))


@functools.partial(jax.jit, static_argnames=("config",))
def _stereo_match_stage(
    kl: Keypoints,
    kr: Keypoints,
    pyr_l_raw: jnp.ndarray,
    pyr_r_raw: jnp.ndarray,
    config: OrbConfig,
    bf: jnp.ndarray,
    min_z: jnp.ndarray,
):
    """Stereo matching + refinement as ONE program (all glue inside)."""
    scale_factors = jnp.asarray(
        [config.scale_factor**l for l in range(config.n_levels)], dtype=jnp.float32
    )
    sm: StereoMatches = match_rectified(
        kl.x, kl.y, kl.level, kl.desc_signed, kl.valid,
        kr.x, kr.y, kr.level, kr.desc_signed, kr.valid,
        pyr_l_raw, pyr_r_raw, kl.xl, kl.yl, scale_factors, bf, min_z,
    )
    return sm, jnp.sum(kl.valid.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("config",))
def _search_optimize_stage(
    kl: Keypoints,
    u_right: jnp.ndarray,
    config: OrbConfig,
    bf: jnp.ndarray,
    cam,                      # cameras.models.Camera (pytree)
    T0,                       # geometry.SE3 initial pose guess
    map_u: jnp.ndarray,       # (M,) projected map-point u
    map_v: jnp.ndarray,       # (M,)
    map_desc: jnp.ndarray,    # (M, 256) int8
    map_pos: jnp.ndarray,     # (M, 3) world positions
    map_radius: jnp.ndarray,  # (M,) search radii
    map_lmin: jnp.ndarray,    # (M,) int32
    map_lmax: jnp.ndarray,    # (M,) int32
    map_ok: jnp.ndarray,      # (M,) bool
):
    """Search-by-projection + association gather + motion-only pose
    optimization as ONE program (all glue inside; no host round-trips).

    Kept SEPARATE from the stereo-match program, like the extraction /
    matching split in the module docstring."""
    from fasttrack_tpu.ops.project_match import search_by_projection
    from fasttrack_tpu.optim.pose_opt import pose_optimize

    scale_factors = jnp.asarray(
        [config.scale_factor**l for l in range(config.n_levels)], dtype=jnp.float32
    )
    res = search_by_projection(
        map_u, map_v, map_desc, map_radius, map_lmin, map_lmax, map_ok,
        kl.x, kl.y, kl.desc_signed, kl.level, kl.valid,
    )
    obs_uv = jnp.stack([kl.x[res.idx], kl.y[res.idx]], -1)
    obs_ur = u_right[res.idx]
    inv_sigma2 = 1.0 / (scale_factors[kl.level[res.idx]] ** 2)
    opt = pose_optimize(
        cam, bf, T0, map_pos, obs_uv, obs_ur, inv_sigma2, res.ok
    )
    return res, opt


@jax.jit
def pack_frame_for_host(fd: FrameData):
    """Pack the host-needed frame state into TWO buffers: a (7, N) f32 block
    (x, y, level, angle, u_right, depth, valid) + the (N, 32) packed
    descriptors. The tracker's per-frame snapshot then costs two
    device->host fetches (~60 KB) instead of ten (incl. a 256 KB int8
    matrix); the signed descriptors are reconstructed on host from the
    packed bits."""
    k = fd.kps
    f32 = jnp.stack([
        k.x, k.y, k.level.astype(jnp.float32), k.angle,
        fd.u_right, fd.depth, k.valid.astype(jnp.float32),
    ])
    return f32, k.desc_packed


def tracking_hot_path(
    images: jnp.ndarray,      # (2, H, W) stacked L/R images (uint8 ok)
    config: OrbConfig,
    bf: jnp.ndarray,
    min_z: jnp.ndarray,
    cam,
    T0,
    map_u, map_v, map_desc, map_pos, map_radius, map_lmin, map_lmax, map_ok,
):
    """The full per-frame tracking hot path in exactly THREE device programs
    (extract; stereo-match; search+optimize) with zero eager glue between
    them — the configuration bench.py measures. As in the reference's
    persistent device residency (KernelController.cu:100-117), all
    intermediates stay on device. The caller uploads both camera images
    as ONE stacked uint8 tensor — one host->device transfer per frame."""
    from fasttrack_tpu.ops.extractor import extract_orb_pair_stacked

    kl, kr, pyr_l, pyr_r = extract_orb_pair_stacked(images, config)
    sm, n_valid = _stereo_match_stage(
        kl, kr, pyr_l.raw, pyr_r.raw, config, bf, min_z
    )
    res, opt = _search_optimize_stage(
        kl, sm.u_right, config, bf, cam, T0,
        map_u, map_v, map_desc, map_pos, map_radius, map_lmin, map_lmax, map_ok,
    )
    return FrameData(kl, kr, sm.u_right, sm.depth, n_valid), res, opt


def process_stereo_frame(
    image_left: jnp.ndarray,
    image_right: jnp.ndarray,
    config: OrbConfig,
    bf: jnp.ndarray,
    min_z: jnp.ndarray,
) -> FrameData:
    """Rectified stereo frame: flat 2-camera extraction + stereo depth.

    Exactly two compiled programs (extract, match) with no eager glue
    between them (see module docstring).
    """
    from fasttrack_tpu.ops.extractor import extract_orb_pair

    kl, kr, pyr_l, pyr_r = extract_orb_pair(image_left, image_right, config)
    sm, n_valid = _stereo_match_stage(
        kl, kr, pyr_l.raw, pyr_r.raw, config, bf, min_z
    )
    return FrameData(kl, kr, sm.u_right, sm.depth, n_valid)


@functools.partial(jax.jit, static_argnames=("config",))
def process_fisheye_frame_stacked(
    images: jnp.ndarray,      # (2, H, W) stacked L/R fisheye images
    config: OrbConfig,
    rig,                      # cameras.stereo.StereoRig (KB8 pair, pytree)
) -> FrameData:
    """Fisheye stereo frame (Frame.cc fisheye ctor :1115-1203 +
    ComputeStereoFishEyeMatches + KannalaBrandt8::TriangulateMatches):
    brute-force Hamming + Lowe ratio across the two cameras, then
    parallax/reprojection-gated triangulation gives matched left keypoints a
    depth. u_right stays -1 (no rectified row geometry); depth drives
    stereo-point creation exactly like the reference's mvDepth."""
    from fasttrack_tpu.cameras.stereo import triangulate_matches
    from fasttrack_tpu.ops.extractor import extract_orb_pair_stacked
    from fasttrack_tpu.ops.stereo_match import match_fisheye

    kl, kr, _, _ = extract_orb_pair_stacked(images, config)
    fm = match_fisheye(kl.desc_signed, kl.valid, kr.desc_signed, kr.valid)
    scale2 = jnp.asarray(
        [config.scale_factor ** (2 * l) for l in range(config.n_levels)],
        dtype=jnp.float32,
    )
    uv_l = jnp.stack([kl.x, kl.y], -1)
    uv_r = jnp.stack([kr.x[fm.idx_right], kr.y[fm.idx_right]], -1)
    z, _, tri_ok = triangulate_matches(
        rig, uv_l, uv_r, scale2[kl.level], scale2[kr.level[fm.idx_right]]
    )
    good = fm.valid & tri_ok & kl.valid
    depth = jnp.where(good, z, -1.0)
    neg = jnp.full((kl.x.shape[0],), -1.0)
    return FrameData(kl, kr, neg, depth, jnp.sum(kl.valid.astype(jnp.int32)))


def process_stereo_frame_stacked(
    images: jnp.ndarray,      # (2, H, W) stacked L/R (uint8 ok)
    config: OrbConfig,
    bf: jnp.ndarray,
    min_z: jnp.ndarray,
) -> FrameData:
    """process_stereo_frame with a single stacked image upload (the
    tracker's entry: one uint8 host->device transfer per frame)."""
    from fasttrack_tpu.ops.extractor import extract_orb_pair_stacked

    kl, kr, pyr_l, pyr_r = extract_orb_pair_stacked(images, config)
    sm, n_valid = _stereo_match_stage(
        kl, kr, pyr_l.raw, pyr_r.raw, config, bf, min_z
    )
    return FrameData(kl, kr, sm.u_right, sm.depth, n_valid)
