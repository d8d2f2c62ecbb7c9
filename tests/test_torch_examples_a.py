"""The port's example scripts, group a of five (``tests/test_torch_examples_*.py``, split so that
``--dist loadfile`` spreads them): each exits 0 on the CPU from its own
directory, as ``tests/test_examples.py`` runs the JAX package's, one
subprocess at a time."""

import pytest

from torch_examples import run_example

SCRIPTS = ['run_full_stack.py']


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs(script):
    run_example(script)


def test_full_stack_example_fused_chain():
    """``--fused``: the chain of K7, K6 and K5 with the postfilter, their
    plain versions on the CPU."""
    assert "offline (fused)" in run_example("run_full_stack.py", "--fused")
