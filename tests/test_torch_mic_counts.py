"""The mic counts the port's kernels take, 2 to 8, on the CPU: the plain
version of K1 (``fused_mvdr_scan``) at 3 and 6 mics against the JAX Pallas
kernel in interpret mode, float32, at the tolerance
test_torch_mvdr_scan.py holds 4 mics to; and the wrappers' ranges.  K2/K4
are in test_torch_mic_counts_enhance.py (float64, against the JAX scan) and
test_torch_mic_counts_interpret.py (float32, with K8), K5 in
test_torch_mic_counts_gsc.py.  The kernels themselves are held to these plain versions on the card
(``chip_smoke.py``) and in the CPU rehearsal of their sources
(``test_torch_csrc_rehearsal.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.ops.pallas_mvdr import pallas_mvdr_scan
from distantspeech_tpu_torch.ops import cuda_enhance as ce, cuda_flms as cf, cuda_mvdr as cm


@pytest.mark.parametrize("gain", [False, True], ids=["mvdr", "mvdr_omlsa"])
@pytest.mark.parametrize("M", [3, 6])
def test_k1_plain_matches_pallas_interpret(M, gain):
    rng = np.random.default_rng(M)
    T, B, F = 23, 3, 5
    Z = (rng.standard_normal((T, B, F, M)) + 1j * rng.standard_normal((T, B, F, M))).astype(np.complex64)
    gate = (rng.uniform(size=(T, B, F)) > 0.3).astype(np.float32)
    gate[0] = 1.0  # every lane opens on frame 0, so no output is 0/0
    steer = np.exp(1j * rng.uniform(0, 2 * np.pi, (F, M))).astype(np.complex64)
    p = rng.uniform(size=(T, B, F)).astype(np.float32)
    lam = rng.uniform(0.2, 3.0, size=(T, B, F)).astype(np.float32)
    jkw = dict(p=jnp.asarray(p), lam=jnp.asarray(lam)) if gain else {}
    tkw = dict(p=torch.as_tensor(p), lam=torch.as_tensor(lam)) if gain else {}
    want = np.asarray(pallas_mvdr_scan(jnp.asarray(Z), jnp.asarray(gate), jnp.asarray(steer), rel_diag=1e-3, f_tile=8,
                                       t_chunk=8, interpret=True, **jkw))
    got = cm.fused_mvdr_scan_plain(torch.as_tensor(Z), torch.as_tensor(gate), torch.as_tensor(steer), rel_diag=1e-3,
                                   **tkw)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_wrapper_ranges():
    """The wrappers' ranges: mics 2 to 8 for K1, K2/K4, K5 and K8 (and
    K10), n_fft 256, 512 and 1024 for K4; what lies just outside raises on
    the card (the CPU runs the plain versions, which take any shape)."""
    assert list(cm._KERNEL_MICS) == list(ce._KERNEL_MICS) == list(cf._FDGSC_MICS) == list(range(2, 9))
    assert list(cf._KERNEL_CHANNELS) == list(range(1, 8))
    assert ce._FULL_NFFT == (256, 512, 1024)
    for M in (1, 9):
        assert M not in ce._KERNEL_MICS and M not in cf._FDGSC_MICS and M - 1 not in cf._KERNEL_CHANNELS
    assert 768 not in ce._FULL_NFFT and 2048 not in ce._FULL_NFFT
