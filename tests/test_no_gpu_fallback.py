"""The measuring entry points refuse to run without a GPU.

`chip_smoke.py` and `bench.py` time and check the program on the card. If
JAX finds no GPU they must fail and print no result, rather than measure the
CPU under a GPU's name.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--four"],
                                  ["bench.py", "--config", "cornell"]],
                         ids=["chip_smoke", "chip_smoke_four", "bench_cornell"])
def test_cpu_only_run_fails_without_a_result(args):
    r = _run(args)
    assert r.returncode != 0, r.stdout + r.stderr
    assert '"ok"' not in r.stdout and "WURBLPT_BENCH_RESULT" not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the rest of the repo, the script has
    no program to run and must fail too."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
