"""Guard for the jax-0.9.0 dispatch-fastpath fault (tests/conftest.py).

On jax 0.9.0 the suite neutralizes the fastpath in conftest, so the fault
cannot bite and this test is skipped. On any OTHER jax version the conftest
no longer applies the patch (a hard import error would make the suite
unrunnable everywhere else) — instead this test executes the
standalone reproducer in a clean subprocess WITHOUT the patch and fails if
the cross-program re-dispatch fault still exists, pointing the upgrader at
the workaround to extend or delete.
"""

import os
import pathlib
import subprocess
import sys

import jax
import pytest

REPRO = pathlib.Path(__file__).resolve().parent.parent / "tools" / "repro_fastpath.py"


@pytest.mark.skipif(jax.__version__ == "0.9.0",
                    reason="fastpath neutralized by conftest on 0.9.0")
def test_fastpath_fault_does_not_reproduce_unpatched():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPRO)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "FAULT PRESENT" not in r.stdout, (
        "jax dispatch-fastpath fault reproduces on jax "
        f"{jax.__version__} (see tests/conftest.py workaround):\n"
        + r.stdout[-2000:] + r.stderr[-2000:])
