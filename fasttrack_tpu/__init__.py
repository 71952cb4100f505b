"""fasttrack_tpu — a visual-inertial SLAM engine in JAX, run on the GPU.

A from-scratch JAX/XLA re-design of the capability set of sfu-rsl/FastTrack
(a GPU-accelerated ORB-SLAM3 fork):

- ORB feature extraction (pyramid resize/blur, FAST, IC-angle, rotated BRIEF)
  as batched XLA programs over a padded level tensor.
- Rectified-stereo / fisheye descriptor matching and map-point
  search-by-projection as masked Hamming-distance matmuls (descriptors as
  signed-bit vectors, Hamming distance = int8 matmul).
- Pose optimization / local & inertial bundle adjustment as a JAX
  Levenberg-Marquardt solver with Schur-complement reduction.
- Tracking / LocalMapping / LoopClosing pipeline with a multi-map Atlas,
  IMU preintegration, per-stage offload toggles and timing stats.
- EuRoC / TUM-VI / KITTI / TUM RGB-D dataset drivers and ATE evaluation.

The reference implementation is studied, not copied; docstrings cite
reference files as `File.cc:line` for parity checking.
"""

__version__ = "0.1.0"

import jax as _jax

# On the GPU, float32 matmuls at the default precision run in TF32, which
# keeps ~3 decimal digits — fine for image smoothing, not for geometry:
# point-coordinate matmuls would round at ~1e-3 relative and the error
# rides through projection into every match window and pose solve.
# Matmuls are therefore pinned to full f32 globally; the single-image
# pyramid (ops/pyramid.py) explicitly opts back into DEFAULT, and the
# Hamming matchers are int8 (exact at any precision).
_jax.config.update("jax_default_matmul_precision", "highest")

from fasttrack_tpu.kernels import KernelConfig, Stage  # noqa: F401
