"""Small host-side (NumPy) numeric helpers."""

from __future__ import annotations

import numpy as np


def orthonormalize(R: np.ndarray) -> np.ndarray:
    """Project a near-rotation back onto SO(3) (SVD, det-corrected).

    Host poses must be re-orthonormalized whenever they come back from the
    f32 device optimizers: the reference gets this for free from Sophus'
    normalized-quaternion storage, while raw matrices compound roundoff
    geometrically through the velocity-model composition chain (measured
    ortho-error growth x~2.5/frame before the fix).
    """
    U, _, Vt = np.linalg.svd(R)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    return U @ D @ Vt


def device_fetch(*arrays):
    """Fetch device arrays to host: issue async copies for ALL first, then
    materialize, so the copies overlap instead of waiting one by one."""
    for a in arrays:
        f = getattr(a, "copy_to_host_async", None)
        if f is not None:
            try:
                f()
            except Exception:
                pass
    import numpy as _np

    out = [_np.asarray(a) for a in arrays]
    return out[0] if len(out) == 1 else out
