"""Runs one ``examples_torch`` script the way ``tests/test_examples.py`` runs
the JAX package's: ``python script --cpu`` from the script's own directory
(so the script must find the package from its own path)."""

import os
import subprocess
import sys

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples_torch")


def run_example(script: str, *argv: str) -> str:
    env = dict(os.environ, OMP_NUM_THREADS="1")  # one thread: the tests add no parallel work of their own
    res = subprocess.run([sys.executable, script, "--cpu", *argv], cwd=EXAMPLES_DIR, capture_output=True, text=True,
                         timeout=280, env=env)
    assert res.returncode == 0, f"{script} failed:\n{res.stderr[-2000:]}"
    return res.stdout
