"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (bench, chip smoke, examples, tests, tools):
if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it on its own and nothing
here sets another directory. Otherwise the cache lives at a fixed path inside
the checkout, ``.jax_cache/<name>`` (listed in ``.gitignore``). The path is
part of what makes a cache hit, so it depends on neither the process id nor
the time.

``name`` separates device configurations whose entries must not mix: the
test suite runs on 8 virtual CPU devices, and an executable compiled for one
device count can be looked up by a process with another ("Execution supplied
N buffers but compiled program expected M"), so the suite uses its own
subdirectory.
"""

from __future__ import annotations

import os
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def cache_dir(name: str = "default") -> str:
    """The directory the cache uses for `name`: the environment's, if set."""
    return os.environ.get(ENV_VAR) or os.path.join(CACHE_ROOT, name)


def enable_compile_cache(name: str = "default") -> str:
    """Point JAX's persistent cache at `cache_dir(name)`; returns the path.

    Sets `jax_compilation_cache_dir` only when the environment leaves it
    unset."""
    import jax

    path = cache_dir(name)
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
