"""Settings: typed YAML config parser (src/Settings.cc semantics).

Reads the reference's "File.version: 1.0" YAML schema (Camera1.*, Camera2.*,
Stereo.*, ORBextractor.*, IMU.*, Viewer.*, System.*) so existing EuRoC /
TUM-VI config files drive this framework unmodified. These files are
OpenCV FileStorage YAML, of which they use a small subset that
`parse_opencv_yaml` reads without a YAML library: a `%YAML` header, flat
`Key.sub: value` scalars, and `!!opencv-matrix` blocks with `rows`, `cols`,
`dt` and a (possibly multi-line) `data: [...]` list.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from fasttrack_tpu.cameras import Camera, make_kannala_brandt8, make_pinhole


@dataclasses.dataclass
class Settings:
    camera1: Camera = None
    camera2: Optional[Camera] = None
    camera_type: str = "PinHole"
    dist1: Optional[np.ndarray] = None  # pinhole [k1 k2 p1 p2 (k3)]
    dist2: Optional[np.ndarray] = None
    bf: float = 0.0
    baseline: float = 0.0
    T_c1_c2: Optional[np.ndarray] = None   # 4x4 Stereo.T_c1_c2
    th_depth: float = 35.0
    # ORB
    n_features: int = 1024
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    # IMU
    T_b_c1: Optional[np.ndarray] = None
    imu_noise_gyro: float = 1.7e-4
    imu_noise_acc: float = 2e-3
    imu_walk_gyro: float = 1.9e-5
    imu_walk_acc: float = 3e-3
    imu_frequency: float = 200.0
    # image
    width: int = 752
    height: int = 480
    new_width: int = 0    # Camera.newWidth/newHeight: resize on input
    new_height: int = 0
    fps: float = 20.0
    rgb: bool = True
    # system
    load_atlas: Optional[str] = None
    save_atlas: Optional[str] = None


_INT = re.compile(r"[-+]?\d+")


def _strip_comment(line: str) -> str:
    """Drop a `#` comment that is not inside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return line[:i]
    return line


def _scalar(text: str):
    """A scalar or `[a, b, ...]` list: quoted string, int, float, bool or
    bare string."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if text.startswith("[") and text.endswith("]"):
        return [_scalar(x) for x in text[1:-1].split(",") if x.strip()]
    if _INT.fullmatch(text):
        return int(text)
    try:
        return float(text)
    except ValueError:
        return {"true": True, "false": False}.get(text.lower(), text)


def parse_opencv_yaml(text: str) -> dict:
    """Parse the OpenCV-FileStorage subset of the reference's settings files.

    Top-level `key: value` lines become scalars; a key whose value is
    `!!opencv-matrix` (or empty) opens a mapping filled by the indented
    lines below it. A value with an unclosed `[` continues over the next
    lines. Raises ValueError on a line that is not `key: value`."""
    entries = []   # (line number, indent, key, value text)
    open_entry = None
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if open_entry is not None:
            open_entry[3] += " " + line.strip()
            if open_entry[3].count("[") <= open_entry[3].count("]"):
                entries.append(tuple(open_entry))
                open_entry = None
            continue
        stripped = line.strip()
        if not stripped or stripped.startswith("%") or stripped == "---":
            continue
        key, sep, value = stripped.partition(":")
        if not sep or not key.strip():
            raise ValueError(f"settings line {n}: expected 'key: value', got {raw!r}")
        entry = [n, len(line) - len(line.lstrip()), key.strip(), value.strip()]
        if value.count("[") > value.count("]"):
            open_entry = entry
        else:
            entries.append(tuple(entry))
    if open_entry is not None:
        raise ValueError(f"settings line {open_entry[0]}: unclosed '['")

    out: dict = {}
    block = None   # the mapping that indented lines belong to
    for n, indent, key, value in entries:
        if indent:
            if block is None:
                raise ValueError(f"settings line {n}: indented line outside a block")
            block[key] = _scalar(value)
        elif value in ("", "!!opencv-matrix"):
            block = out[key] = {}
        else:
            block = None
            out[key] = _scalar(value)
    return out


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        return parse_opencv_yaml(f.read())


def _mat(node) -> np.ndarray:
    if isinstance(node, dict) and "data" in node:
        return np.asarray(node["data"], np.float64).reshape(
            int(node.get("rows", 4)), int(node.get("cols", 4))
        )
    return np.asarray(node, np.float64)


def load_settings(path: str) -> Settings:
    d = _load_yaml(path)

    def g(key, default=None):
        return d.get(key, default)

    s = Settings()
    s.camera_type = g("Camera.type", g("Camera1.type", "PinHole"))
    s.width = int(g("Camera.width", 752))
    s.height = int(g("Camera.height", 480))
    s.new_width = int(g("Camera.newWidth", 0) or 0)
    s.new_height = int(g("Camera.newHeight", 0) or 0)
    s.fps = float(g("Camera.fps", 20.0))
    s.rgb = bool(g("Camera.RGB", 1))

    def make_cam(prefix):
        fx = g(f"{prefix}.fx")
        if fx is None:
            return None
        fx, fy = float(fx), float(g(f"{prefix}.fy"))
        cx, cy = float(g(f"{prefix}.cx")), float(g(f"{prefix}.cy"))
        if s.camera_type in ("KannalaBrandt8", "Fisheye"):
            return make_kannala_brandt8(
                fx, fy, cx, cy,
                float(g(f"{prefix}.k1", 0)), float(g(f"{prefix}.k2", 0)),
                float(g(f"{prefix}.k3", 0)), float(g(f"{prefix}.k4", 0)),
                s.width, s.height,
            )
        return make_pinhole(fx, fy, cx, cy, s.width, s.height)

    s.camera1 = make_cam("Camera1") or make_cam("Camera")
    s.camera2 = make_cam("Camera2")
    if s.camera_type == "PinHole":
        # pinhole distortion (plumb bob) -> stereo rectification at startup
        def dist_of(prefix):
            ks = [g(f"{prefix}.k1"), g(f"{prefix}.k2"),
                  g(f"{prefix}.p1"), g(f"{prefix}.p2")]
            if all(k is None for k in ks):
                return None
            d = [float(k or 0.0) for k in ks]
            k3 = g(f"{prefix}.k3")
            if k3 is not None:
                d.append(float(k3))
            return np.asarray(d)
        d1 = dist_of("Camera1")
        s.dist1 = d1 if d1 is not None else dist_of("Camera")
        s.dist2 = dist_of("Camera2")
    if g("Stereo.T_c1_c2") is not None:
        s.T_c1_c2 = _mat(g("Stereo.T_c1_c2"))
    # Camera.bf (legacy format) is focal*baseline; Stereo.b (File.version
    # 1.0) is the baseline in METERS — the reference multiplies by fx
    # (Settings.cc:306 `bf_ = b_ * fx`). Conflating them scaled bf by 1/fx
    # and broke stereo depth through the driver path.
    bf = g("Camera.bf", None)
    b = g("Stereo.b", None)
    if bf is not None:
        s.bf = float(bf)
        if s.camera1 is not None:
            s.baseline = s.bf / float(np.asarray(s.camera1.params)[0])
    elif b is not None and s.camera1 is not None:
        s.baseline = float(b)
        s.bf = s.baseline * float(np.asarray(s.camera1.params)[0])
    elif s.T_c1_c2 is not None and s.camera1 is not None:
        s.baseline = float(np.linalg.norm(s.T_c1_c2[:3, 3]))
        s.bf = s.baseline * float(np.asarray(s.camera1.params)[0])
    s.th_depth = float(g("Stereo.ThDepth", g("Camera.ThDepth", 35.0)))

    s.n_features = int(g("ORBextractor.nFeatures", 1024))
    s.scale_factor = float(g("ORBextractor.scaleFactor", 1.2))
    s.n_levels = int(g("ORBextractor.nLevels", 8))
    s.ini_th_fast = float(g("ORBextractor.iniThFAST", 20))
    s.min_th_fast = float(g("ORBextractor.minThFAST", 7))

    if g("IMU.T_b_c1") is not None:
        s.T_b_c1 = _mat(g("IMU.T_b_c1"))
    s.imu_noise_gyro = float(g("IMU.NoiseGyro", 1.7e-4))
    s.imu_noise_acc = float(g("IMU.NoiseAcc", 2e-3))
    s.imu_walk_gyro = float(g("IMU.GyroWalk", 1.9e-5))
    s.imu_walk_acc = float(g("IMU.AccWalk", 3e-3))
    s.imu_frequency = float(g("IMU.Frequency", 200.0))

    s.load_atlas = g("System.LoadAtlasFromFile")
    s.save_atlas = g("System.SaveAtlasToFile")
    return s
