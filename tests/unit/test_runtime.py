"""Process set-up: the compile cache helper, the platform rule, and the
chip smoke script's refusal to run off the card."""

import os
import subprocess
import sys

import pytest

from rgbd_pose_estimation_tpu.utils import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class TestCompileCache:
    def _calls(self, monkeypatch):
        calls = []
        monkeypatch.setattr(
            runtime.jax.config, "update", lambda k, v: calls.append((k, v))
        )
        return calls

    def test_env_var_is_honoured(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        calls = self._calls(monkeypatch)
        assert runtime.enable_compile_cache() == str(tmp_path)
        assert calls == []  # JAX reads the variable itself

    def test_fixed_path_in_checkout(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        calls = self._calls(monkeypatch)
        path = runtime.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]


def test_no_platform_branches_in_package():
    """Each hot operation has one implementation on every platform (PERF.md
    records why): nothing in the package compares backend names, and no
    hand-written Pallas kernel is left to choose between."""
    import re

    pkg = os.path.join(ROOT, "rgbd_pose_estimation_tpu")
    bad = re.compile(r"default_backend\(\)\s*[!=]=|experimental\.pallas|experimental import pallas")
    hits = []
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                for i, line in enumerate(open(path), 1):
                    if bad.search(line):
                        hits.append(f"{path}:{i}: {line.strip()}")
    assert not hits, hits


class TestChipSmoke:
    def _run(self, cwd, script):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        return subprocess.run(
            [sys.executable, script], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=300,
        )

    def test_fails_on_cpu(self):
        r = self._run(ROOT, os.path.join(ROOT, "chip_smoke.py"))
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
        assert "needs a GPU" in r.stderr

    def test_fails_without_the_repo(self, tmp_path):
        script = tmp_path / "chip_smoke.py"
        script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
        r = self._run(str(tmp_path), str(script))
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


@pytest.mark.parametrize(
    "coordinator,procs,expect",
    [
        ("localhost:12345", 4, [2]),  # one host: each process owns one card
        ("10.0.0.7:12345", 2, None),  # across hosts: every local card
        ("localhost:12345", 1, "no call"),  # single process: nothing to do
    ],
)
def test_distributed_init_device_ownership(monkeypatch, coordinator, procs, expect):
    from rgbd_pose_estimation_tpu.parallel import mesh

    calls = []
    monkeypatch.setattr(
        mesh.jax.distributed, "initialize", lambda **kw: calls.append(kw)
    )
    mesh.distributed_init(coordinator, procs, min(2, procs - 1))
    if expect == "no call":
        assert calls == []
    else:
        assert calls[0]["local_device_ids"] == expect


def test_orb_without_opencv_names_the_alternative(monkeypatch):
    import numpy as np

    from rgbd_pose_estimation_tpu.features.frontend import detect_orb

    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now fails
    with pytest.raises(ImportError, match="--detector tpu"):
        detect_orb(np.zeros((32, 32), np.float32))
