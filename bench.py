"""Benchmark: per-frame tracking hot path on the GPU.

Measures the full per-frame compute pipeline the reference times as
"tracking ms/frame" (BASELINE.md): host->device image upload (ONE stacked
uint8 transfer), stereo ORB extraction (pyramid/FAST/orientation/BRIEF),
rectified stereo matching, search-by-projection against a local map, and
motion-only pose optimization — three device programs
(frame_pipeline.tracking_hot_path).

HONEST timing: every frame ends with a block_until_ready on the pose result
— a real tracker reads the pose back each frame, so per-frame *sync*
latency is the metric (a pipelined measurement would hide the per-frame
round trip and overlap frames a tracker cannot overlap). Every frame uses
fresh image content so runtime-level caching/replay cannot fake the number.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
vs_baseline > 1 means faster than the reference's best published number
(all-GPU, PO off: 6.83 ms/frame on EuRoC MH01, grouped_plot.ipynb).

Fails loudly (non-zero exit, error JSON on stdout) if JAX's default device
is not a GPU or the output is garbage: it never measures the CPU.
"""

import json
import sys
import time

import numpy as np

REFERENCE_MS = 6.83  # MH01, all-GPU, PO off (BASELINE.md)

H, W = 480, 752
N_MAP = 2048  # local map points fed to search-by-projection
N_FRAMES = 120


def _init_backend():
    """Import jax and return it with its devices; raise unless the default
    device is a GPU."""
    import jax

    from fasttrack_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {devs[0].platform} ({devs[0]})"
        )
    return jax, devs


def make_frames(n):
    """n distinct stereo pairs: textured base + per-frame shift/noise so
    every upload has fresh content (no runtime replay short-circuits)."""
    rng = np.random.default_rng(0)
    base = np.kron(
        rng.integers(0, 256, size=(H // 8 + 4, W // 8 + 4)), np.ones((8, 8))
    ).astype(np.uint8)
    frames = []
    for i in range(n):
        dy, dx = (i * 3) % 24, (i * 5) % 24
        left = base[dy:dy + H, dx:dx + W]
        right = np.roll(left, -7, axis=1)  # disparity-like shift
        noise = rng.integers(0, 8, size=(2, H, W)).astype(np.uint8)
        frames.append(
            (np.stack([left, right]).astype(np.int16) + noise)
            .clip(0, 255).astype(np.uint8)
        )
    return frames


def main():
    try:
        jax, devs = _init_backend()
    except RuntimeError as e:
        print(json.dumps({"metric": "tracking_ms_per_frame", "value": None,
                          "unit": "ms", "vs_baseline": None, "error": str(e)}))
        sys.exit(1)

    import jax.numpy as jnp

    from fasttrack_tpu.cameras import make_pinhole
    from fasttrack_tpu.frame_pipeline import tracking_hot_path
    from fasttrack_tpu.geometry import se3_identity
    from fasttrack_tpu.ops import OrbConfig

    cfg = OrbConfig(height=H, width=W, n_features=1024, n_levels=8)
    cam = make_pinhole(458.654, 457.296, 367.215, 248.375, W, H)
    bf = jnp.float32(47.9)
    min_z = jnp.float32(47.9 / 458.654)

    frames = make_frames(N_FRAMES)
    rng = np.random.default_rng(1)
    # All map-side operands staged on device ONCE (persistent residency,
    # KernelController.cu:100-117): per-frame host->device traffic is the
    # ONE stacked uint8 image pair only.
    map_pos = jnp.asarray(
        np.stack(
            [rng.uniform(-4, 4, N_MAP), rng.uniform(-3, 3, N_MAP),
             rng.uniform(4, 12, N_MAP)], -1,
        ).astype(np.float32)
    )
    map_u = jnp.asarray(rng.uniform(30, 450, N_MAP).astype(np.float32))
    map_v = jnp.asarray(rng.uniform(30, 450, N_MAP).astype(np.float32))
    map_desc = jnp.asarray(
        (2 * rng.integers(0, 2, size=(N_MAP, 256)) - 1).astype(np.int8)
    )
    map_radius = jnp.full(N_MAP, 8.0)
    map_lmin = jnp.zeros(N_MAP, jnp.int32)
    map_lmax = jnp.full(N_MAP, 7, jnp.int32)
    map_ok = jnp.ones(N_MAP, bool)
    T0 = se3_identity()

    def step(stacked):
        return tracking_hot_path(
            jnp.asarray(stacked), cfg, bf, min_z, cam, T0,
            map_u, map_v, map_desc, map_pos, map_radius, map_lmin, map_lmax, map_ok,
        )

    # Warmup / compile.
    fd, res, opt = step(frames[0])
    jax.block_until_ready(opt)
    for i in range(1, 4):  # settle caches/streams
        jax.block_until_ready(step(frames[i])[2])

    # Timed run: per-frame sync (the pose is read back every frame in real
    # tracking), fresh image content every frame.
    times = []
    for i in range(N_FRAMES):
        t0 = time.perf_counter()
        fd, res, opt = step(frames[i])
        jax.block_until_ready((res, opt))
        times.append((time.perf_counter() - t0) * 1e3)
    dt_ms = float(np.median(times))

    # Output sanity after the timed loop.
    n_valid = int(fd.n_valid)
    if not (np.isfinite(np.asarray(opt.pose.t)).all() and n_valid > 0):
        print(json.dumps({"metric": "tracking_ms_per_frame", "value": None,
                          "unit": "ms", "vs_baseline": None,
                          "error": f"garbage output (n_valid={n_valid})"}))
        sys.exit(1)

    print(
        json.dumps(
            {
                "metric": "tracking_ms_per_frame",
                "value": round(dt_ms, 3),
                "unit": "ms",
                "vs_baseline": round(REFERENCE_MS / dt_ms, 3),
                "mean_ms": round(float(np.mean(times)), 3),
                "p90_ms": round(float(np.percentile(times, 90)), 3),
                "n_valid": n_valid,
                "sync": "per-frame block_until_ready, fresh content",
                "device": {"platform": devs[0].platform,
                           "kind": devs[0].device_kind, "count": len(devs)},
            }
        )
    )


if __name__ == "__main__":
    main()
