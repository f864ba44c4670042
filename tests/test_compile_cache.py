"""The persistent compile cache lands where `utils/compile_cache.py` says."""

import os
import subprocess
import sys

import jax
import pytest

from wurblpt_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROBE = ("from wurblpt_tpu.utils.compile_cache import enable_compile_cache;"
          "import jax; p = enable_compile_cache({name!r});"
          "print(p); print(jax.config.jax_compilation_cache_dir)")


def _probe(name, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != compile_cache.ENV_VAR}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    if env_dir is not None:
        env[compile_cache.ENV_VAR] = env_dir
    out = subprocess.run([sys.executable, "-c", _PROBE.format(name=name)],
                         env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True)
    helper, config = out.stdout.split()
    return helper, config


def test_path_is_fixed_inside_the_checkout():
    """Two processes started at different times get the same directory, and
    it is the one listed in .gitignore."""
    a = _probe("default", None)
    b = _probe("default", None)
    assert a == b
    helper, config = a
    assert helper == config == os.path.join(REPO, ".jax_cache", "default")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_environment_variable_is_honoured(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets no directory of
    its own: JAX's config reads the environment's."""
    helper, config = _probe("default", str(tmp_path))
    assert helper == config == str(tmp_path)
    assert not os.path.exists(os.path.join(str(tmp_path), "default"))


@pytest.mark.parametrize("name", ["default", "cpu8"])
def test_device_configurations_get_separate_directories(name, monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.cache_dir(name) == os.path.join(
        compile_cache.CACHE_ROOT, name)
    other = "cpu8" if name == "default" else "default"
    assert compile_cache.cache_dir(name) != compile_cache.cache_dir(other)


def test_suite_uses_its_own_subdirectory():
    """conftest.py points the 8-virtual-device suite at `cpu8` (unless the
    environment names a directory)."""
    want = os.environ.get(compile_cache.ENV_VAR) or os.path.join(
        compile_cache.CACHE_ROOT, "cpu8")
    assert jax.config.jax_compilation_cache_dir == want
