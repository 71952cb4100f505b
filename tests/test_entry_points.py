"""What the entry scripts share: the compile-cache placement, the GPU
smoke run's device check and comparisons, and side-effect-free imports."""

import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

import chip_smoke
from fasttrack_tpu import compile_cache

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the one fixed
    directory inside the checkout."""
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(os.path.abspath(ROOT), ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.cache_dir() == want
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _dev(platform):
    return types.SimpleNamespace(platform=platform, device_kind=platform)


def test_chip_smoke_refuses_cpu_devices():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu([])


def test_chip_smoke_counts_gpus():
    gpus = [_dev("gpu") for _ in range(4)]
    assert chip_smoke.require_gpu(gpus) == gpus[:1]
    assert chip_smoke.require_gpu(gpus, 4) == gpus
    with pytest.raises(RuntimeError, match="need 4 GPUs"):
        chip_smoke.require_gpu(gpus[:2], 4)


def _kps(xy, level, desc):
    return {"x": np.asarray([p[0] for p in xy], np.float32),
            "y": np.asarray([p[1] for p in xy], np.float32),
            "level": np.asarray(level), "valid": np.ones(len(xy), bool),
            "desc": np.asarray(desc, np.uint8).reshape(len(xy), 1)}


def test_compare_keypoints_is_order_free():
    a = _kps([(1, 1), (5, 5), (9, 9), (3, 3)], [0, 1, 0, 2], [0, 1, 2, 3])
    b = _kps([(9, 9), (1, 1), (5, 5), (4, 4)], [0, 0, 1, 2], [3, 0, 1, 3])
    r = chip_smoke.compare_keypoints(a, b)
    assert r["overlap"] == pytest.approx(3 / 4)
    # (9,9): 2 ^ 3 -> 1 differing bit; the other two agree
    assert r["desc_bits"] == pytest.approx(1 / 3)


def test_compare_matches_by_keypoint_position():
    g = _kps([(1, 1), (5, 5)], [0, 0], [0, 0])
    c = _kps([(5, 5), (1, 1)], [0, 0], [0, 0])
    g.update(idx=np.asarray([0, 1, 1, 0]), ok=np.asarray([True, True, False, True]))
    c.update(idx=np.asarray([1, 0, 0, 1]), ok=np.asarray([True, True, False, False]))
    assert chip_smoke.compare_matches(g, c) == (3, 4)


def test_make_problem_import_leaves_jax_platforms():
    """Importing the BA window module (and the bench that uses it) must not
    force a platform or rewrite XLA_FLAGS."""
    code = (
        "import os, jax\n"
        "before = (jax.config.jax_platforms, os.environ.get('XLA_FLAGS'))\n"
        "from fasttrack_tpu.parallel.synthetic_window import make_problem\n"
        "import tools.bench_multichip\n"
        "assert (jax.config.jax_platforms, os.environ.get('XLA_FLAGS')) == before\n"
        "prob, cam, bf, n_obs = make_problem(K=4, L=16, obs_per_point=2)\n"
        "assert prob.points.shape == (16, 3) and n_obs > 0\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = ""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
