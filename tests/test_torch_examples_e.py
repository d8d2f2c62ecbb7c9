"""The port's example scripts, group e of five (``tests/test_torch_examples_*.py``, split so that
``--dist loadfile`` spreads them): each exits 0 on the CPU from its own
directory, as ``tests/test_examples.py`` runs the JAX package's, one
subprocess at a time."""

import pytest

from torch_examples import run_example

SCRIPTS = ['run_kws_cleaner.py', 'run_postfilter.py', 'run_transform.py', 'run_vad.py', 'run_wpe.py']


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs(script):
    run_example(script)
