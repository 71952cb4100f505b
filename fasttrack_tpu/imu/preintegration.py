"""IMU preintegration on manifold, as a lax.scan over fixed-size batches.

Parity target: IMU::Preintegrated (include/ImuTypes.h:143-221,
src/ImuTypes.cc IntegrateNewMeasurement): delta R/V/P on SO(3)xR^6, the five
bias Jacobians JRg, JVg, JVa, JPg, JPa, and the 15x15 covariance propagated
with the standard (Forster et al.) discrete model, plus bias-corrected
delta getters used by the inertial optimization edges (G2oTypes EdgeInertial).

Fixed-shape design: measurements arrive as padded fixed-shape arrays
(acc (N,3), gyro (N,3), dt (N,)) with dt==0 rows acting as no-ops, so one
jitted scan covers every frame regardless of sample count; batches of
preintegrations vmap cleanly (used by the inertial BA over keyframe windows).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fasttrack_tpu.geometry.so3 import hat, so3_exp, so3_log, so3_right_jacobian

GRAVITY_VALUE = 9.81  # ImuTypes.h:43
# tuple, not a module-level jnp array; jnp.asarray'd at trace time
GRAVITY = (0.0, 0.0, -GRAVITY_VALUE)


def _mm(a, b):
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _mv(A, x):
    return jnp.einsum("...ij,...j->...i", A, x, precision=jax.lax.Precision.HIGHEST)


class ImuBias(NamedTuple):
    """Gyro + accelerometer bias (IMU::Bias, ImuTypes.h:46-126)."""

    bg: jnp.ndarray  # (..., 3)
    ba: jnp.ndarray  # (..., 3)

    @staticmethod
    def zero(dtype=jnp.float32) -> "ImuBias":
        return ImuBias(jnp.zeros(3, dtype), jnp.zeros(3, dtype))


class ImuCalib(NamedTuple):
    """IMU-camera calibration (IMU::Calib): T_bc and noise densities."""

    R_bc: jnp.ndarray  # (3, 3) body <- camera rotation
    t_bc: jnp.ndarray  # (3,)
    noise_gyro: float
    noise_acc: float
    walk_gyro: float
    walk_acc: float
    freq: float

    @staticmethod
    def default(freq: float = 200.0) -> "ImuCalib":
        return ImuCalib(
            jnp.eye(3, dtype=jnp.float32),
            jnp.zeros(3, dtype=jnp.float32),
            1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3, freq,
        )

    def noise_cov(self) -> jnp.ndarray:
        """6x6 discrete noise covariance Nga (ImuTypes Calib ctor: sigma^2 * freq)."""
        sg2 = self.noise_gyro**2 * self.freq
        sa2 = self.noise_acc**2 * self.freq
        return jnp.diag(jnp.asarray([sg2] * 3 + [sa2] * 3, dtype=jnp.float32))

    def walk_cov(self) -> jnp.ndarray:
        """6x6 random-walk covariance NgaWalk (sigma^2 / freq)."""
        wg2 = self.walk_gyro**2 / self.freq
        wa2 = self.walk_acc**2 / self.freq
        return jnp.diag(jnp.asarray([wg2] * 3 + [wa2] * 3, dtype=jnp.float32))


class Preintegrated(NamedTuple):
    """Preintegrated deltas between two frames/keyframes.

    Fields mirror IMU::Preintegrated (ImuTypes.h:179-197): dT, dR, dV, dP,
    the bias Jacobians, the 15x15 covariance C (order: [phi, v, p, bg, ba]),
    the linearization bias b0, and average acc/gyro (used by IMU init).
    """

    dT: jnp.ndarray
    dR: jnp.ndarray  # (3, 3)
    dV: jnp.ndarray  # (3,)
    dP: jnp.ndarray  # (3,)
    JRg: jnp.ndarray  # (3, 3)
    JVg: jnp.ndarray
    JVa: jnp.ndarray
    JPg: jnp.ndarray
    JPa: jnp.ndarray
    C: jnp.ndarray  # (15, 15)
    b0: ImuBias
    avgA: jnp.ndarray
    avgW: jnp.ndarray

    @staticmethod
    def identity(b0: ImuBias | None = None) -> "Preintegrated":
        eye = jnp.eye(3, dtype=jnp.float32)
        zero3 = jnp.zeros(3, dtype=jnp.float32)
        zero33 = jnp.zeros((3, 3), dtype=jnp.float32)
        return Preintegrated(
            jnp.asarray(0.0, jnp.float32), eye, zero3, zero3,
            zero33, zero33, zero33, zero33, zero33,
            jnp.zeros((15, 15), dtype=jnp.float32),
            b0 if b0 is not None else ImuBias.zero(),
            zero3, zero3,
        )


def integrate_measurements(
    pre: Preintegrated,
    acc: jnp.ndarray,   # (N, 3) raw accelerometer samples
    gyro: jnp.ndarray,  # (N, 3) raw gyro samples
    dt: jnp.ndarray,    # (N,)   per-sample integration times; 0 = padding
    calib: ImuCalib,
) -> Preintegrated:
    """Integrate a padded block of measurements (IntegrateNewMeasurement,
    src/ImuTypes.cc), one lax.scan step per sample; dt==0 rows are no-ops."""
    Nga = calib.noise_cov()
    NgaWalk = calib.walk_cov()

    def step(p: Preintegrated, x):
        a_raw, w_raw, h = x
        valid = h > 0
        hs = jnp.where(valid, h, 1.0)  # avoid 0*inf paths; masked out below
        a = a_raw - p.b0.ba
        w = w_raw - p.b0.bg

        # Position/velocity updates with the *old* dR (ImuTypes.cc order).
        dRa = _mv(p.dR, a)
        dP_new = p.dP + p.dV * hs + 0.5 * dRa * hs * hs
        dV_new = p.dV + dRa * hs

        # Covariance propagation (A, B of the 9x9 [phi, v, p] block).
        Wa = hat(a)
        dRWa = _mm(p.dR, Wa)
        dRi = so3_exp(w * hs)
        Jr = so3_right_jacobian(w * hs)

        A = jnp.eye(9, dtype=jnp.float32)
        A = A.at[0:3, 0:3].set(dRi.T)
        A = A.at[3:6, 0:3].set(-dRWa * hs)
        A = A.at[6:9, 0:3].set(-0.5 * dRWa * hs * hs)
        A = A.at[6:9, 3:6].set(jnp.eye(3) * hs)

        B = jnp.zeros((9, 6), dtype=jnp.float32)
        B = B.at[0:3, 0:3].set(Jr * hs)
        B = B.at[3:6, 3:6].set(p.dR * hs)
        B = B.at[6:9, 3:6].set(0.5 * p.dR * hs * hs)

        C9 = p.C[:9, :9]
        C9_new = _mm(_mm(A, C9), A.T) + _mm(_mm(B, Nga), B.T)
        C_new = p.C.at[:9, :9].set(C9_new)
        C_new = C_new.at[9:, 9:].add(NgaWalk)

        # Jacobian updates (position/velocity first with old values).
        JPa_new = p.JPa + p.JVa * hs - 0.5 * p.dR * hs * hs
        JPg_new = p.JPg + p.JVg * hs - 0.5 * _mm(dRWa, p.JRg) * hs * hs
        JVa_new = p.JVa - p.dR * hs
        JVg_new = p.JVg - _mm(dRWa, p.JRg) * hs

        dR_new = _mm(p.dR, dRi)
        JRg_new = _mm(dRi.T, p.JRg) - Jr * hs

        n_old = jnp.maximum(p.dT * calib.freq, 0.0)  # approx sample count
        avgA_new = (p.avgA * n_old + a_raw) / (n_old + 1.0)
        avgW_new = (p.avgW * n_old + w_raw) / (n_old + 1.0)

        def sel(new, old):
            return jax.tree_util.tree_map(
                lambda n, o: jnp.where(valid, n, o), new, old
            )

        p_new = Preintegrated(
            p.dT + jnp.where(valid, hs, 0.0),
            dR_new, dV_new, dP_new,
            JRg_new, JVg_new, JVa_new, JPg_new, JPa_new,
            C_new, p.b0, avgA_new, avgW_new,
        )
        return sel(p_new, p), None

    out, _ = jax.lax.scan(step, pre, (acc, gyro, dt))
    return out


def preintegrate(
    acc: jnp.ndarray, gyro: jnp.ndarray, dt: jnp.ndarray,
    calib: ImuCalib, b0: ImuBias | None = None,
) -> Preintegrated:
    return integrate_measurements(Preintegrated.identity(b0), acc, gyro, dt, calib)


# --- bias-corrected getters (ImuTypes.h GetDeltaRotation/Velocity/Position) --


def delta_rotation(pre: Preintegrated, b: ImuBias) -> jnp.ndarray:
    dbg = b.bg - pre.b0.bg
    return _mm(pre.dR, so3_exp(_mv(pre.JRg, dbg)))


def delta_velocity(pre: Preintegrated, b: ImuBias) -> jnp.ndarray:
    dbg = b.bg - pre.b0.bg
    dba = b.ba - pre.b0.ba
    return pre.dV + _mv(pre.JVg, dbg) + _mv(pre.JVa, dba)


def delta_position(pre: Preintegrated, b: ImuBias) -> jnp.ndarray:
    dbg = b.bg - pre.b0.bg
    dba = b.ba - pre.b0.ba
    return pre.dP + _mv(pre.JPg, dbg) + _mv(pre.JPa, dba)


# ---------------------------------------------------------------------------
# Host (NumPy) preintegration — the tracker's running accumulation.
#
# The tracker needs the preintegrated state EVERY frame on the host (IMU
# prediction, keyframe storage); keeping the running integration on device
# cost ~11 device->host fetches per frame just to read it back. Frame
# sample counts are tiny (5-30), so the host loop is microseconds; the
# device optimizers receive the state as ONE packed upload
# (pack_preintegrated / unpack_preintegrated).
# ---------------------------------------------------------------------------

import numpy as _np


def _np_hat(v):
    return _np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]],
                      [-v[1], v[0], 0.0]])


def _np_so3_exp(phi):
    th = _np.linalg.norm(phi)
    K = _np_hat(phi)
    if th < 1e-10:
        return _np.eye(3) + K + 0.5 * K @ K
    return (_np.eye(3) + _np.sin(th) / th * K
            + (1.0 - _np.cos(th)) / th**2 * K @ K)


def _np_right_jacobian(phi):
    th = _np.linalg.norm(phi)
    K = _np_hat(phi)
    if th < 1e-6:
        return _np.eye(3) - 0.5 * K
    return (_np.eye(3) - (1.0 - _np.cos(th)) / th**2 * K
            + (th - _np.sin(th)) / th**3 * K @ K)


class HostPreintegrated:
    """Mutable float64 mirror of Preintegrated for the tracker's running
    accumulation (IMU::Preintegrated's role on the host side). Field names
    match the device NamedTuple so downstream host consumers (IMU init,
    window BA stacking, atlas serialization) take either."""

    __slots__ = ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa",
                 "C", "b0", "avgA", "avgW")

    class _B:
        __slots__ = ("bg", "ba")

        def __init__(self, bg, ba):
            self.bg = _np.asarray(bg, _np.float64)
            self.ba = _np.asarray(ba, _np.float64)

    def __init__(self, bg=None, ba=None):
        self.dT = 0.0
        self.dR = _np.eye(3)
        self.dV = _np.zeros(3)
        self.dP = _np.zeros(3)
        z = _np.zeros((3, 3))
        self.JRg, self.JVg, self.JVa = z.copy(), z.copy(), z.copy()
        self.JPg, self.JPa = z.copy(), z.copy()
        self.C = _np.zeros((15, 15))
        self.b0 = HostPreintegrated._B(
            bg if bg is not None else _np.zeros(3),
            ba if ba is not None else _np.zeros(3),
        )
        self.avgA = _np.zeros(3)
        self.avgW = _np.zeros(3)

    def copy(self) -> "HostPreintegrated":
        p = HostPreintegrated(self.b0.bg.copy(), self.b0.ba.copy())
        p.dT = self.dT
        for f in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C",
                  "avgA", "avgW"):
            setattr(p, f, getattr(self, f).copy())
        return p

    def integrate(self, acc, gyro, dts, calib: ImuCalib):
        """IntegrateNewMeasurement (src/ImuTypes.cc) — identical update
        order to the device scan step."""
        sg2 = calib.noise_gyro**2 * calib.freq
        sa2 = calib.noise_acc**2 * calib.freq
        Nga = _np.diag([sg2] * 3 + [sa2] * 3)
        wg2 = calib.walk_gyro**2 / calib.freq
        wa2 = calib.walk_acc**2 / calib.freq
        NgaWalk = _np.diag([wg2] * 3 + [wa2] * 3)
        for a_raw, w_raw, h in zip(_np.asarray(acc, _np.float64),
                                   _np.asarray(gyro, _np.float64),
                                   _np.asarray(dts, _np.float64)):
            if h <= 0:
                continue
            a = a_raw - self.b0.ba
            w = w_raw - self.b0.bg
            dRa = self.dR @ a
            self.dP = self.dP + self.dV * h + 0.5 * dRa * h * h
            self.dV = self.dV + dRa * h
            Wa = _np_hat(a)
            dRWa = self.dR @ Wa
            dRi = _np_so3_exp(w * h)
            Jr = _np_right_jacobian(w * h)
            A = _np.eye(9)
            A[0:3, 0:3] = dRi.T
            A[3:6, 0:3] = -dRWa * h
            A[6:9, 0:3] = -0.5 * dRWa * h * h
            A[6:9, 3:6] = _np.eye(3) * h
            B = _np.zeros((9, 6))
            B[0:3, 0:3] = Jr * h
            B[3:6, 3:6] = self.dR * h
            B[6:9, 3:6] = 0.5 * self.dR * h * h
            self.C[:9, :9] = A @ self.C[:9, :9] @ A.T + B @ Nga @ B.T
            self.C[9:, 9:] += NgaWalk
            self.JPa = self.JPa + self.JVa * h - 0.5 * self.dR * h * h
            self.JPg = self.JPg + self.JVg * h - 0.5 * (dRWa @ self.JRg) * h * h
            self.JVa = self.JVa - self.dR * h
            self.JVg = self.JVg - (dRWa @ self.JRg) * h
            self.dR = self.dR @ dRi
            self.JRg = dRi.T @ self.JRg - Jr * h
            n_old = max(self.dT * calib.freq, 0.0)
            self.avgA = (self.avgA * n_old + a_raw) / (n_old + 1.0)
            self.avgW = (self.avgW * n_old + w_raw) / (n_old + 1.0)
            self.dT += h


PRE_PACKED_SIZE = 298  # 1+9+3+3+5*9+225+3+3+3+3


def pack_preintegrated(p) -> _np.ndarray:
    """HostPreintegrated -> one (298,) float32 buffer (ONE upload for the
    device optimizers instead of 14 separate arrays)."""
    return _np.concatenate([
        [p.dT], p.dR.ravel(), p.dV, p.dP,
        p.JRg.ravel(), p.JVg.ravel(), p.JVa.ravel(),
        p.JPg.ravel(), p.JPa.ravel(), p.C.ravel(),
        p.b0.bg, p.b0.ba, p.avgA, p.avgW,
    ]).astype(_np.float32)


def unpack_preintegrated(buf: jnp.ndarray) -> Preintegrated:
    """Inverse of pack_preintegrated (jnp slicing; call inside jit)."""
    o = 1
    dR = buf[o:o + 9].reshape(3, 3); o += 9
    dV = buf[o:o + 3]; o += 3
    dP = buf[o:o + 3]; o += 3
    Js = []
    for _ in range(5):
        Js.append(buf[o:o + 9].reshape(3, 3)); o += 9
    C = buf[o:o + 225].reshape(15, 15); o += 225
    bg = buf[o:o + 3]; o += 3
    ba = buf[o:o + 3]; o += 3
    avgA = buf[o:o + 3]; o += 3
    avgW = buf[o:o + 3]; o += 3
    return Preintegrated(buf[0], dR, dV, dP, *Js, C, ImuBias(bg, ba),
                         avgA, avgW)


def predict_state(
    R_wb: jnp.ndarray, v_w: jnp.ndarray, p_w: jnp.ndarray,
    pre: Preintegrated, b: ImuBias,
):
    """Dead-reckon the next body state (Tracking::PredictStateIMU,
    Tracking.cc:1795): R2 = R1 dR(b), v2 = v1 + g t + R1 dV(b),
    p2 = p1 + v1 t + 0.5 g t^2 + R1 dP(b)."""
    t = pre.dT
    R2 = _mm(R_wb, delta_rotation(pre, b))
    g = jnp.asarray(GRAVITY, dtype=v_w.dtype)
    v2 = v_w + g * t + _mv(R_wb, delta_velocity(pre, b))
    p2 = p_w + v_w * t + 0.5 * g * t * t + _mv(R_wb, delta_position(pre, b))
    return R2, v2, p2
