"""Accelerator compute ops (the reference's CUDA kernel layer, re-designed).

Everything here is fixed-shape, jit-safe, and batched plain JAX; XLA
compiles it for the device.
"""

from fasttrack_tpu.ops.pyramid import build_pyramid, PyramidConfig  # noqa: F401
from fasttrack_tpu.ops.fast import fast_detect, FastConfig  # noqa: F401
from fasttrack_tpu.ops.orientation import ic_angles  # noqa: F401
from fasttrack_tpu.ops.descriptor import brief_descriptors, pack_bits, unpack_bits  # noqa: F401
from fasttrack_tpu.ops.extractor import (  # noqa: F401
    OrbConfig,
    Keypoints,
    extract_orb,
    make_extract_fn,
)
from fasttrack_tpu.ops.hamming import (  # noqa: F401
    hamming_matrix,
    hamming_matrix_packed,
    signed_descriptors,
)
