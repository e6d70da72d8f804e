"""Platform dispatch, compile-cache location and the GPU-only entry
points' refusal to run elsewhere."""

import os
import runpy
import shutil
import subprocess
import sys

import jax
import pytest

from occuseg.ops import conv as conv_ops
from occuseg.ops import dispatch, triton_conv
from occuseg.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,conv", [
    ("cpu", conv_ops.gather_conv),
    ("gpu", triton_conv.triton_gather_conv)])
def test_dispatch_known_platforms(platform, conv):
    impl = dispatch.impl(platform)
    assert impl.platform == platform
    assert impl.conv is conv


@pytest.mark.parametrize("platform", ["rocm", "metal", "unknown"])
def test_dispatch_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no sparse-conv implementation"):
        dispatch.impl(platform)


def test_dispatch_default_is_first_device():
    assert dispatch.impl().platform == jax.devices()[0].platform == "cpu"


@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_dir(monkeypatch, tmp_path, env):
    before = jax.config.jax_compilation_cache_dir
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    else:
        want = str(tmp_path / env)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    try:
        assert runtime.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


class _CacheCalled(Exception):
    pass


@pytest.mark.parametrize("script", [
    "train_instance.py", "train_semantic.py", "test_semantic.py",
    "evaluate_instance.py", "checkpoint_parity.py"])
def test_scripts_enable_compile_cache_first(monkeypatch, script):
    """Each JAX entry point under scripts/ turns the compile cache on
    before it does anything else (without that, `--help` exits first)."""
    def called():
        raise _CacheCalled

    monkeypatch.setattr(runtime, "enable_compile_cache", called)
    monkeypatch.setattr(sys, "argv", [script, "--help"])
    with pytest.raises(_CacheCalled):
        runpy.run_path(os.path.join(REPO, "scripts", script),
                       run_name="__main__")


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        runtime.require_gpu()


def test_device_info_names_the_device():
    info = runtime.device_info()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_points_refuse_without_gpu(script):
    r = _run([script], REPO)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
