"""Multi-chip scaling: device meshes, sharded tracking, distributed BA.

The reference is single-process/single-GPU (SURVEY.md 2.4); this package is
the new design territory: map points and keyframe blocks shard across a
jax.sharding.Mesh, landmark Schur complements reduce via psum inside
shard_map (NCCL over NVLink between the GPUs of one host), and batches of
frames extract in parallel across devices.
"""

from fasttrack_tpu.parallel.dist_ba import (  # noqa: F401
    distributed_ba_iteration,
    distributed_bundle_adjustment,
    make_mesh,
    sharded_extract_batch,
)
from fasttrack_tpu.parallel.multihost import (  # noqa: F401
    initialize_distributed,
    make_global_mesh,
    shard_ba_problem,
)
