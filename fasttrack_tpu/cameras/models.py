"""Pinhole and Kannala-Brandt-8 camera models.

Parity targets:
- Pinhole: include/CameraModels/Pinhole.h / Pinhole.cpp (project, unproject,
  projectJac).
- KannalaBrandt8: KannalaBrandt8.cpp:28-95 (theta-polynomial projection),
  :111-176 (Newton unprojection), equidistant fisheye with 4 distortion
  coefficients (k0..k3 on theta^3, theta^5, theta^7, theta^9).

Design notes: a fixed-width parameter vector (8 floats, unused
slots zero) keeps one jitted code path per camera *kind* while staying fully
batched; `kind` is a Python-level static so lax.cond is not needed.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

PINHOLE = "pinhole"
FISHEYE_KB8 = "kb8"

_MAX_PARAMS = 8


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Camera:
    """A camera model as a JAX pytree: `params` (8,) [fx fy cx cy k0 k1 k2 k3]
    is a traced leaf; `kind`/`width`/`height` are static aux data, so a
    Camera can be passed through jit boundaries directly and `project`
    dispatches on `kind` at trace time."""

    kind: str
    params: jnp.ndarray
    width: int
    height: int

    def tree_flatten(self):
        return (self.params,), (self.kind, self.width, self.height)

    @classmethod
    def tree_unflatten(cls, aux, children):
        kind, width, height = aux
        return cls(kind, children[0], width, height)

    def __hash__(self):
        return hash((self.kind, self.width, self.height))

    @property
    def fx(self):
        return self.params[0]

    @property
    def fy(self):
        return self.params[1]

    @property
    def cx(self):
        return self.params[2]

    @property
    def cy(self):
        return self.params[3]

    def K(self) -> jnp.ndarray:
        fx, fy, cx, cy = self.params[0], self.params[1], self.params[2], self.params[3]
        z = jnp.zeros_like(fx)
        o = jnp.ones_like(fx)
        return jnp.stack(
            [
                jnp.stack([fx, z, cx]),
                jnp.stack([z, fy, cy]),
                jnp.stack([z, z, o]),
            ]
        )


def make_pinhole(fx, fy, cx, cy, width=752, height=480) -> Camera:
    p = jnp.zeros(_MAX_PARAMS, dtype=jnp.float32)
    p = p.at[:4].set(jnp.asarray([fx, fy, cx, cy], dtype=jnp.float32))
    return Camera(PINHOLE, p, int(width), int(height))


def make_kannala_brandt8(fx, fy, cx, cy, k0, k1, k2, k3, width=512, height=512) -> Camera:
    p = jnp.asarray([fx, fy, cx, cy, k0, k1, k2, k3], dtype=jnp.float32)
    return Camera(FISHEYE_KB8, p, int(width), int(height))


# --- projection -------------------------------------------------------------


def _project_pinhole(params, X):
    z = X[..., 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = params[0] * X[..., 0] / safe_z + params[2]
    v = params[1] * X[..., 1] / safe_z + params[3]
    return jnp.stack([u, v], axis=-1)


def _project_kb8(params, X):
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    r2 = x * x + y * y
    r = jnp.sqrt(jnp.maximum(r2, 1e-18))
    theta = jnp.arctan2(r, z)
    t2 = theta * theta
    # theta_d = theta (1 + k0 t2 + k1 t4 + k2 t6 + k3 t8), Horner form
    poly = 1.0 + t2 * (params[4] + t2 * (params[5] + t2 * (params[6] + t2 * params[7])))
    theta_d = theta * poly
    scale = jnp.where(r2 < 1e-16, 1.0, theta_d / r)
    # At r->0 the point is on-axis: u = cx, v = cy (scale*x -> 0 anyway).
    u = params[0] * scale * x + params[2]
    v = params[1] * scale * y + params[3]
    return jnp.stack([u, v], axis=-1)


def project(cam: Camera, X: jnp.ndarray) -> jnp.ndarray:
    """Camera-frame points (..., 3) -> pixels (..., 2)."""
    if cam.kind == PINHOLE:
        return _project_pinhole(cam.params, X)
    elif cam.kind == FISHEYE_KB8:
        return _project_kb8(cam.params, X)
    raise ValueError(cam.kind)


def project_point(cam: Camera, X: jnp.ndarray) -> jnp.ndarray:
    return project(cam, X)


# --- unprojection -----------------------------------------------------------


def _unproject_pinhole(params, uv):
    mx = (uv[..., 0] - params[2]) / params[0]
    my = (uv[..., 1] - params[3]) / params[1]
    return jnp.stack([mx, my, jnp.ones_like(mx)], axis=-1)


def _unproject_kb8(params, uv, iters: int = 10):
    """Invert theta_d = theta * poly(theta^2) by Newton iteration
    (KannalaBrandt8.cpp:111-176 uses the same scheme)."""
    mx = (uv[..., 0] - params[2]) / params[0]
    my = (uv[..., 1] - params[3]) / params[1]
    theta_d = jnp.sqrt(mx * mx + my * my)
    theta_d_c = jnp.clip(theta_d, -jnp.pi / 2, jnp.pi / 2)

    def body(_, theta):
        t2 = theta * theta
        f = theta * (
            1.0 + t2 * (params[4] + t2 * (params[5] + t2 * (params[6] + t2 * params[7])))
        ) - theta_d_c
        df = (
            1.0
            + t2
            * (3 * params[4] + t2 * (5 * params[5] + t2 * (7 * params[6] + t2 * 9 * params[7])))
        )
        return theta - f / jnp.maximum(df, 1e-6)

    theta = jax.lax.fori_loop(0, iters, body, theta_d_c)
    scale = jnp.where(theta_d < 1e-8, 1.0, jnp.tan(theta) / theta_d)
    return jnp.stack([mx * scale, my * scale, jnp.ones_like(mx)], axis=-1)


def unproject(cam: Camera, uv: jnp.ndarray) -> jnp.ndarray:
    """Pixels (..., 2) -> unit-depth ray (..., 3) with z == 1."""
    if cam.kind == PINHOLE:
        return _unproject_pinhole(cam.params, uv)
    elif cam.kind == FISHEYE_KB8:
        return _unproject_kb8(cam.params, uv)
    raise ValueError(cam.kind)


def project_jacobian(cam: Camera, X: jnp.ndarray) -> jnp.ndarray:
    """d(uv)/dX, shape (..., 2, 3) (GeometricCamera::projectJac).

    Uses jacfwd on the scalar-core projection — XLA fuses this into the same
    kernel as the projection itself, so there is no perf reason for the
    reference's hand-derived formulas.
    """

    def proj_single(x):
        return project(cam, x)

    flatX = X.reshape(-1, 3)
    J = jax.vmap(jax.jacfwd(proj_single))(flatX)
    return J.reshape(*X.shape[:-1], 2, 3)


def uncertainty2(cam: Camera, uv: jnp.ndarray) -> jnp.ndarray:
    """Per-observation uncertainty (GeometricCamera::uncertainty2 — the
    reference returns 1.0 for both models)."""
    return jnp.ones(uv.shape[:-1], dtype=uv.dtype)
