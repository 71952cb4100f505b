"""FAST corner detection over the padded pyramid, fully vectorized.

Parity target: src/fast.cu (fast_corner kernel, :243-330; segment test
isKeyPoint2 :182, cornerScore :157) — FAST-9/16 with a low-threshold retry
when a cell found nothing, NMS, and per-level compaction.

Vectorized re-design:
- The segment test's contiguous-arc check runs as bit tricks on a 16-bit
  mask plane: run-length >= 9 via mask-rotation doubling (replaces the
  reference's 64KB lookup table `c_table`, which would be a per-pixel
  scalar gather).
- The corner *score* (max threshold at which the pixel stays a corner,
  = max over the 16 arcs of the min |diff| in a 9-arc) is computed by the
  same doubling trick on float planes; the dual-threshold retry
  (iniThFAST=20 / minThFAST=7) becomes a per-cell select on the score map —
  no retry pass needed.
- NMS is a 3x3 max-pool; compaction is per-cell argmax + per-level top-k
  (replacing atomicInc compaction + the host octree; the per-cell cap gives
  the same spatial spread DistributeOctTree aims for, ORBextractor.cc:1112).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# 16-point Bresenham circle, radius 3, OpenCV order (dx, dy).
CIRCLE = np.asarray(
    [
        (3, 0), (3, 1), (2, 2), (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1),
        (-3, 0), (-3, -1), (-2, -2), (-1, -3), (0, -3), (1, -3), (2, -2), (3, -1),
    ],
    dtype=np.int32,
)


class FastConfig(NamedTuple):
    ini_threshold: float = 20.0   # iniThFAST (Tracking settings)
    min_threshold: float = 7.0    # minThFAST
    cell: int = 8                 # suppression cell for compaction
    retry_cell: int = 32          # dual-threshold decision cell (~reference's 35px grid)
    # Keypoint border: the reference uses EDGE_THRESHOLD-3=16 for FAST and
    # clamps descriptor samples at image borders; we instead exclude the
    # 41x41 descriptor-patch margin outright.
    border: int = 21


def _rot16(m: jnp.ndarray, k: int) -> jnp.ndarray:
    """Circular right-rotation of 16-bit masks held in int32 planes."""
    return ((m >> k) | (m << (16 - k))) & 0xFFFF


def _roll_axis0(x: jnp.ndarray, k: int) -> jnp.ndarray:
    return jnp.roll(x, shift=-k, axis=0)


def fast_score(levels: jnp.ndarray) -> jnp.ndarray:
    """(L, H, W) intensity -> (L, H, W) FAST-9 corner score.

    score(p) = max threshold t such that p passes the segment test, i.e.
    max over the 16 arc starts of the min over 9 consecutive circle diffs
    (for the bright case; symmetric for dark). Non-corners get <= 0 scores.
    """
    # diffs[i] = I(p + c_i) - I(p), via rolls of the whole plane stack.
    diffs = jnp.stack(
        [
            jnp.roll(levels, shift=(-int(dy), -int(dx)), axis=(1, 2)) - levels
            for (dx, dy) in CIRCLE
        ],
        axis=0,
    )  # (16, L, H, W)

    def arc_min9(d):
        m2 = jnp.minimum(d, _roll_axis0(d, 1))
        m4 = jnp.minimum(m2, _roll_axis0(m2, 2))
        m8 = jnp.minimum(m4, _roll_axis0(m4, 4))
        m9 = jnp.minimum(m8, _roll_axis0(d, 8))
        return jnp.max(m9, axis=0)  # best arc start

    bright = arc_min9(diffs)       # >0 iff exists 9-arc all brighter
    dark = arc_min9(-diffs)        # >0 iff exists 9-arc all darker
    return jnp.maximum(bright, dark)


def _cell_threshold(score: jnp.ndarray, cfg: FastConfig) -> jnp.ndarray:
    """Per-pixel threshold: iniTh where the retry-cell has any iniTh corner,
    else minTh (the reference's in-kernel low-threshold retry,
    fast.cu:243-330)."""
    c = cfg.retry_cell
    L, H, W = score.shape
    pooled = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (1, c, c), (1, c, c), "SAME"
    )
    # Broadcast the pooled cell max back to pixels.
    up = jnp.repeat(jnp.repeat(pooled, c, axis=1), c, axis=2)[:, :H, :W]
    has_high = up > cfg.ini_threshold
    return jnp.where(has_high, cfg.ini_threshold, cfg.min_threshold)


def _nms3(score: jnp.ndarray) -> jnp.ndarray:
    pooled = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (1, 3, 3), (1, 1, 1), "SAME"
    )
    return score >= pooled


class FastKeypoints(NamedTuple):
    """Per-level padded keypoint set, level coordinates."""

    x: jnp.ndarray      # (L, K) int32
    y: jnp.ndarray      # (L, K) int32
    score: jnp.ndarray  # (L, K) float32
    valid: jnp.ndarray  # (L, K) bool


@functools.partial(
    jax.jit, static_argnames=("level_sizes", "per_level_k", "cfg")
)
def fast_detect(
    levels: jnp.ndarray,
    level_sizes: tuple,       # static ((h0,w0), ..., (h_{L-1}, w_{L-1}))
    per_level_k: tuple,       # static (n_0, ..., n_{L-1}) features per level
    cfg: FastConfig = FastConfig(),
) -> FastKeypoints:
    """Detect FAST corners on all pyramid levels in one pass.

    Returns fixed-capacity per-level keypoint arrays with K = max(per_level_k)
    (unused per-level slots invalid).
    """
    L, H, W = levels.shape
    score = fast_score(levels)
    thr = _cell_threshold(score, cfg)
    is_corner = score > thr
    is_peak = _nms3(jnp.where(is_corner, score, -jnp.inf)) & is_corner

    # Mask out borders and per-level invalid regions.
    ys = jax.lax.broadcasted_iota(jnp.int32, (L, H, W), 1)
    xs = jax.lax.broadcasted_iota(jnp.int32, (L, H, W), 2)
    region = jnp.zeros((L, H, W), dtype=bool)
    b = cfg.border
    for l, (h, w) in enumerate(level_sizes):
        region = region.at[l].set(
            (ys[l] >= b) & (ys[l] < h - b) & (xs[l] >= b) & (xs[l] < w - b)
        )
    masked = jnp.where(is_peak & region, score, -jnp.inf)

    # Per-cell argmax compaction: one winner per cell x cell tile.
    c = cfg.cell
    Hp, Wp = -(-H // c) * c, -(-W // c) * c
    padded = jnp.pad(masked, ((0, 0), (0, Hp - H), (0, Wp - W)), constant_values=-jnp.inf)
    tiles = padded.reshape(L, Hp // c, c, Wp // c, c).transpose(0, 1, 3, 2, 4)
    tiles = tiles.reshape(L, (Hp // c) * (Wp // c), c * c)
    cell_best = jnp.max(tiles, axis=-1)                    # (L, n_cells)
    cell_arg = jnp.argmax(tiles, axis=-1)                  # (L, n_cells)
    n_cells_y, n_cells_x = Hp // c, Wp // c
    cell_iy = jax.lax.broadcasted_iota(jnp.int32, (L, n_cells_y * n_cells_x), 1) // n_cells_x
    cell_ix = jax.lax.broadcasted_iota(jnp.int32, (L, n_cells_y * n_cells_x), 1) % n_cells_x
    win_y = cell_iy * c + cell_arg // c
    win_x = cell_ix * c + cell_arg % c

    # Per-level top-k over cell winners.
    K = max(per_level_k)
    n_cells = cell_best.shape[1]
    k_eff = min(K, n_cells)
    top_scores, top_idx = jax.lax.top_k(cell_best, k_eff)  # (L, k_eff)
    if k_eff < K:
        top_scores = jnp.pad(
            top_scores, ((0, 0), (0, K - k_eff)), constant_values=-jnp.inf
        )
        top_idx = jnp.pad(top_idx, ((0, 0), (0, K - k_eff)))
    sel_y = jnp.take_along_axis(win_y, top_idx, axis=1)
    sel_x = jnp.take_along_axis(win_x, top_idx, axis=1)
    valid = jnp.isfinite(top_scores)
    # Zero out per-level slots beyond that level's feature budget.
    slot = jax.lax.broadcasted_iota(jnp.int32, (L, K), 1)
    budget = jnp.asarray(per_level_k, dtype=jnp.int32)[:, None]
    valid = valid & (slot < budget)
    return FastKeypoints(
        sel_x.astype(jnp.int32),
        sel_y.astype(jnp.int32),
        jnp.where(valid, top_scores, 0.0),
        valid,
    )
