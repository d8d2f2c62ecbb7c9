"""The port's example scripts, group d of five (``tests/test_torch_examples_*.py``, split so that
``--dist loadfile`` spreads them): each exits 0 on the CPU from its own
directory, as ``tests/test_examples.py`` runs the JAX package's, one
subprocess at a time."""

import pytest

from torch_examples import run_example

SCRIPTS = ['run_binaural.py', 'run_doa.py', 'run_fixedbeamformer.py', 'run_idoa.py']


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs(script):
    run_example(script)
