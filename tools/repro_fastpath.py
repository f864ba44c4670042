"""Standalone repro for the jax-0.9.0 dispatch-fastpath fault that
tests/conftest.py works around on the CPU backend.

Fault signature: run compiled program A, then compiled program B over a
similar arg pytree; B's SECOND execution raises "Execution supplied N buffers
but compiled program expected N+2" — the global shared C++ PjitFunctionCache
mis-associates fastpath data (incl. hoisted const_args) across programs.

Run after any jax upgrade: `python tools/repro_fastpath.py`. Exit 0 with
"FAULT ABSENT" means upstream fixed it and the conftest patch can go. Exit 0
with "FAULT PRESENT" means keep it. (Always exit 0; the *message* is the
result.) `chip_smoke.py` is the full-strength check on the GPU backend: it
runs all its programs in one process without the patch.
"""
import os
import sys

# Force CPU unless the caller explicitly opts into a device platform, so
# the probe never takes a card that another process is using.
if os.environ.get("WURBLPT_REPRO_PLATFORM"):
    os.environ["JAX_PLATFORMS"] = os.environ["WURBLPT_REPRO_PLATFORM"]
else:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))


def main():
    const_a = np.float32(2.0)
    const_b = np.float32(3.0)
    big = jnp.ones((256, 256))

    @jax.jit
    def prog_a(x, y):
        return (x["v"] * const_a + y).sum() + big[0, 0]

    @jax.jit
    def prog_b(x, y):
        return (x["v"] - y * const_b).mean() * big[1, 1]

    args = ({"v": jnp.arange(8.0)}, jnp.float32(1.5))
    try:
        prog_a(*args).block_until_ready()
        prog_a(*args).block_until_ready()
        prog_b(*args).block_until_ready()
        prog_b(*args).block_until_ready()   # the call that faulted
        prog_a(*args).block_until_ready()
    except Exception as e:  # noqa: BLE001
        print(f"FAULT PRESENT on jax {jax.__version__}: {type(e).__name__}: {e}")
        print("-> keep the conftest fastpath patch")
        return 0
    print(f"FAULT ABSENT on jax {jax.__version__} ({jax.devices()[0].platform}): "
          "5 cross-program dispatches succeeded")
    print("NOTE: this is a MINIMAL probe; the original fault needed two "
          "wavefront-scale programs in one process (chip_smoke.py runs "
          "several on the GPU)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
