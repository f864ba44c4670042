"""Test configuration: force CPU with 8 virtual devices BEFORE importing jax.

Multi-device sharding tests run on a virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8), per SURVEY.md section 4's
"multi-host tests runnable on CPU" requirement. The GPU path is exercised by
`chip_smoke.py` and `bench.py`, which run on the card.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Pinned in config as well as in the environment, so a plugin installed
# beside jaxlib cannot win platform selection.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from wurblpt_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# The wavefront loop is expensive to compile, so the suite keeps a persistent
# cache, in its own subdirectory: entries compiled for 8 virtual devices must
# not be found by single-device scripts (see utils/compile_cache.py).
enable_compile_cache("cpu8")

# jax 0.9.0 dispatch-fastpath fault, isolated on the CPU backend: after
# program A runs, a second distinct program B over a similar arg pytree can
# fail on its SECOND execution with "Execution supplied N buffers but
# compiled program expected N+2" — the global shared C++ PjitFunctionCache
# mis-associates fastpath data (including hoisted const_args) across
# programs. Forcing every dispatch down the Python path (fastpath data =
# None) sidesteps it; dispatch overhead is ~100 us/call, noise next to the
# render programs. `chip_smoke.py` runs all its programs in one process
# WITHOUT this patch, which is the check on the GPU backend.
#
# Gated on the exact jax version the fault was isolated on: on any other
# version the patch is not applied, and tests/test_fastpath_guard.py runs the
# standalone reproducer (tools/repro_fastpath.py) to say whether the fault
# still exists there.
if jax.__version__ == "0.9.0":
    import jax._src.pjit as _pjit  # noqa: E402

    _pjit._get_fastpath_data = lambda *a, **k: None
else:
    import warnings

    warnings.warn(
        f"jax {jax.__version__} != 0.9.0: dispatch-fastpath workaround NOT "
        "applied (isolated on 0.9.0); test_fastpath_guard probes whether "
        "the fault reproduces on this version.")
