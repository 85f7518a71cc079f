"""Runtime choices (backend.py) and the chip smoke script's refusals."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from crossscalepatchmatch import CSPMConfig
from crossscalepatchmatch.backend import cost_backend, enable_compile_cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,use_pallas,want", [
    ("gpu", True, "pallas"),
    ("gpu", False, "jnp"),
    ("cpu", True, "jnp"),
])
def test_cost_backend_picks(platform, use_pallas, want):
    cfg = CSPMConfig(use_pallas=use_pallas)
    assert cost_backend(cfg, platform) == want


def test_cost_backend_rejects_unknown_platform():
    with pytest.raises(RuntimeError, match="no plane-cost backend"):
        cost_backend(CSPMConfig(), "metal")


def test_cost_backend_defaults_to_jax_platform():
    # the test harness pins JAX to the CPU
    assert cost_backend(CSPMConfig()) == "jnp"


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_to_repo(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(_REPO, ".jax_cache")
    assert enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_kernel_lowering_names_no_caller():
    """Lowered for the GPU, the window-cost kernel carries its own source
    locations but not its caller's stack, so one program has one compile
    cache key whichever entry point traces it."""
    from crossscalepatchmatch.ops.pallas import window_cost as wc

    enable_compile_cache()
    sds = jax.ShapeDtypeStruct
    args = (sds((2, 16, 32), jnp.int32), sds((2, 9, 16, 32), jnp.float32),
            sds((2,), jnp.float32), sds((2, 1, 16, 32, 3), jnp.float32))

    def cost(img, vol, mc, abc):
        return wc.window_cost_prepared(wc.Prepared(img, vol), mc, abc,
                                       half_wnd=2, max_dis=8, gamma=10.0)

    text = jax.jit(cost).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "window_cost_s0" in text
    assert "test_kernel_lowering_names_no_caller" not in text


def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    proc = _smoke(_REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory without the package, it fails."""
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    proc = _smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
