"""The in-repo parser for the reference's OpenCV-FileStorage settings files,
and that the System imports without a YAML library."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

from fasttrack_tpu.cameras.models import FISHEYE_KB8
from fasttrack_tpu.settings import load_settings, parse_opencv_yaml
from tools.render_euroc_synthetic import settings_yaml

ROOT = os.path.join(os.path.dirname(__file__), "..")

RENDERED_SEQ = types.SimpleNamespace(fx=256.0, fy=256.0, cx=160.0, cy=120.0,
                                     baseline=0.11)

# ORB-SLAM3 EuRoC stereo block (File.version 1.0, distorted pinhole pair).
STEREO_BLOCK = """%YAML:1.0
#--------------------------------------------------------------------------
# Camera Parameters. Adjust them!
#--------------------------------------------------------------------------
File.version: "1.0"
Camera.type: "PinHole"

# Camera calibration and distortion parameters (OpenCV)
Camera1.fx: 458.654
Camera1.fy: 457.296
Camera1.cx: 367.215
Camera1.cy: 248.375
Camera1.k1: -0.28340811
Camera1.k2: 0.07395907
Camera1.p1: 0.00019359
Camera1.p2: 1.76187114e-05

Camera2.fx: 457.587
Camera2.fy: 456.134
Camera2.cx: 379.999
Camera2.cy: 255.238
Camera2.k1: -0.28368365
Camera2.k2: 0.07451284
Camera2.p1: -0.00010473
Camera2.p2: -3.55590700e-05

Camera.width: 752
Camera.height: 480
Camera.fps: 20
Camera.RGB: 1  # Color order of the images (0: BGR, 1: RGB)

Stereo.ThDepth: 60.0
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [0.999997256477797,-0.002317135723275,-0.000343393120620,0.110074137800478,
         0.002312067192432,0.999898048507103,-0.014090668452683,-0.000156612054392,
         0.000376008102320,0.014089835846691,0.999900662638081,0.000889382785432,
         0,0,0,1.000000000000000]

ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
System.SaveAtlasToFile: "euroc_map"
"""

# ORB-SLAM3 TUM-VI fisheye block (Kannala-Brandt 8).
FISHEYE_BLOCK = """%YAML:1.0
File.version: "1.0"
Camera.type: "KannalaBrandt8"
Camera1.fx: 190.978477
Camera1.fy: 190.973307
Camera1.cx: 254.931706
Camera1.cy: 256.897442
Camera1.k1: 0.003482389402
Camera1.k2: 0.000715034845
Camera1.k3: -0.002053236141
Camera1.k4: 0.000202936736
Camera2.fx: 190.442369
Camera2.fy: 190.434438
Camera2.cx: 252.597244
Camera2.cy: 254.917141
Camera2.k1: 0.003400301568
Camera2.k2: 0.001766080800
Camera2.k3: -0.002663119201
Camera2.k4: 0.000329529341
Camera.width: 512
Camera.height: 512
Camera.fps: 20
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [0.999994,0.00101,-0.00331,0.10106,-0.00097,0.99997,0.00715,0.00195,0.00332,-0.00714,0.99996,-0.00104,0.0,0.0,0.0,1.0]
Stereo.ThDepth: 40.0
"""

# ORB-SLAM3 EuRoC IMU block, matrix data spread over several lines.
IMU_BLOCK = """%YAML:1.0
---
File.version: "1.0"
Camera1.fx: 458.654
Camera1.fy: 457.296
Camera1.cx: 367.215
Camera1.cy: 248.375
Stereo.b: 0.11
IMU.T_b_c1: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
          0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
         -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
          0.0, 0.0, 0.0, 1.0]
IMU.InsertKFsWhenLost: 0
IMU.NoiseGyro: 1.7e-4 # 1.6968e-04
IMU.NoiseAcc: 2.0000e-3 # 2.0e-3
IMU.GyroWalk: 1.9393e-05
IMU.AccWalk: 3.0000e-03 # 3e-03
IMU.Frequency: 200.0
"""


def _check_rendered(s):
    assert s.camera_type == "PinHole"
    assert (s.width, s.height, s.fps) == (320, 240, 20.0)
    np.testing.assert_allclose(np.asarray(s.camera1.params)[:4],
                               [256.0, 256.0, 160.0, 120.0])
    assert s.baseline == pytest.approx(0.11)
    assert s.bf == pytest.approx(0.11 * 256.0)
    assert (s.n_features, s.n_levels, s.th_depth) == (512, 4, 60.0)
    np.testing.assert_allclose(s.T_b_c1, np.eye(4))
    assert s.imu_frequency == 200.0


def _check_stereo(s):
    assert s.camera2 is not None and s.T_c1_c2.shape == (4, 4)
    assert s.T_c1_c2[0, 3] == pytest.approx(0.110074137800478)
    assert s.T_c1_c2[3, 3] == 1.0
    assert s.baseline == pytest.approx(np.linalg.norm(s.T_c1_c2[:3, 3]))
    assert s.dist1[3] == pytest.approx(1.76187114e-05)
    assert len(s.dist2) == 4
    assert (s.n_features, s.n_levels) == (1200, 8)
    assert s.rgb is True and s.save_atlas == "euroc_map"


def _check_fisheye(s):
    assert s.camera_type == "KannalaBrandt8"
    assert s.camera1.kind == s.camera2.kind == FISHEYE_KB8
    assert np.asarray(s.camera1.params)[7] == pytest.approx(0.000202936736)
    assert s.T_c1_c2[0, 3] == pytest.approx(0.10106)
    assert (s.width, s.height, s.th_depth) == (512, 512, 40.0)


def _check_imu(s):
    assert s.T_b_c1.shape == (4, 4)
    assert s.T_b_c1[1, 3] == pytest.approx(-0.064676986768)
    assert s.T_b_c1[2, 0] == pytest.approx(-0.0257744366974)
    assert (s.imu_noise_gyro, s.imu_noise_acc) == (1.7e-4, 2.0e-3)
    assert (s.imu_walk_gyro, s.imu_walk_acc) == (1.9393e-05, 3.0e-3)
    assert s.bf == pytest.approx(0.11 * 458.654)


@pytest.mark.parametrize("text, check", [
    (settings_yaml(RENDERED_SEQ, 320, 240, 20.0, imu=True), _check_rendered),
    (STEREO_BLOCK, _check_stereo),
    (FISHEYE_BLOCK, _check_fisheye),
    (IMU_BLOCK, _check_imu),
], ids=["rendered", "stereo", "fisheye", "imu"])
def test_load_settings_blocks(tmp_path, text, check):
    path = tmp_path / "settings.yaml"
    path.write_text(text)
    check(load_settings(str(path)))


def test_parser_scalars_matrices_and_errors():
    d = parse_opencv_yaml(
        '%YAML:1.0\n---\nA.s: "x # not a comment"\nA.i: 3 # comment\n'
        "A.f: -1.5e-3\nA.b: true\nM: !!opencv-matrix\n  rows: 1\n  cols: 2\n"
        "  data: [1,\n    2]\nB: after\n"
    )
    assert d == {"A.s": "x # not a comment", "A.i": 3, "A.f": -1.5e-3,
                 "A.b": True, "M": {"rows": 1, "cols": 2, "data": [1, 2]},
                 "B": "after"}
    with pytest.raises(ValueError, match="line 2"):
        parse_opencv_yaml("A: 1\nnot a key value line\n")
    with pytest.raises(ValueError, match="unclosed"):
        parse_opencv_yaml("M:\n  data: [1, 2\n")


def test_system_imports_without_pyyaml():
    """The main path must not need PyYAML (block it as if not installed)."""
    code = ("import sys; sys.modules['yaml'] = None\n"
            "import fasttrack_tpu.system, fasttrack_tpu.settings\n"
            "assert sys.modules['yaml'] is None\n"
            "fasttrack_tpu.settings.Settings()\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
