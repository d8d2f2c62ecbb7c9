"""Port parity for ``doa/idoa.py`` (``idoa_rtf_grid``, ``idoa_init`` /
``idoa_step`` / ``idoa_run``) against ``distantspeech_tpu`` in float64 on
the CPU, to 1e-9 of the output's scale (a recursion), with the JAX test's
case (the circular 4-mic array, n_fft 256, 360 directions) and a linear
array; the state carried across from JAX by ``convert.idoa_state_from_numpy``
mid-run."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distantspeech_tpu.array.geometry import ArrayGeometry as JGeometry
from distantspeech_tpu.doa import idoa as jidoa
from distantspeech_tpu_torch import convert
from distantspeech_tpu_torch.array.geometry import ArrayGeometry as TGeometry
from distantspeech_tpu_torch.doa import idoa as tidoa

RECURSION = 1e-9


def _close(got, want, tol=RECURSION):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.max(np.abs(want)), 1e-300))


def _cplx(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


CASES = {
    "circular4": (("circular", 4, 0.032), dict(n_fft=256, n_theta=360), (12, 129, 4)),
    "linear3_batched": (("linear", 3, 0.05), dict(n_fft=256, n_theta=180, alpha=0.05), (10, 2, 129, 3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_idoa_run(case):
    (kind, M, d), kw, shape = CASES[case]
    tg, jg = getattr(TGeometry, kind)(M, d, c=343.0), getattr(JGeometry, kind)(M, d, c=343.0)
    tcfg, jcfg = convert.idoa_config_from_dict(kw), jidoa.IdoaConfig(**kw)
    np.testing.assert_array_equal(tidoa.idoa_rtf_grid(tcfg, tg), jidoa.idoa_rtf_grid(jcfg, jg))
    X = _cplx(shape, 1)
    got = tidoa.idoa_run(tcfg, tg, torch.as_tensor(X))
    assert got.dtype == torch.float64 and got.shape == shape[:-1] + (kw["n_theta"],)
    _close(got, jidoa.idoa_run(jcfg, jg, jnp.asarray(X)))


def test_idoa_state_hand_over():
    """JAX's IDOA over the first 6 frames, its state carried across, the port
    over the rest: JAX's whole run."""
    tg, jg = TGeometry.circular(4, 0.032, c=343.0), JGeometry.circular(4, 0.032, c=343.0)
    tcfg, jcfg = tidoa.IdoaConfig(n_fft=256), jidoa.IdoaConfig(n_fft=256)
    X = _cplx((12, 129, 4), 2)
    psi = jnp.asarray(jidoa.idoa_rtf_grid(jcfg, jg))
    psi_norm = jnp.linalg.norm(psi, axis=-2).real
    js = jidoa.idoa_init(jcfg, 4, dtype=jnp.float64)
    for x in X[:6]:
        js, _ = jidoa.idoa_step(jcfg, psi, psi_norm, js, jnp.asarray(x))
    ts = convert.idoa_state_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, "cpu")
    tpsi = torch.as_tensor(tidoa.idoa_rtf_grid(tcfg, tg))
    ps = []
    for x in X[6:]:
        ts, p = tidoa.idoa_step(tcfg, tpsi, torch.linalg.vector_norm(tpsi, dim=-2), ts, torch.as_tensor(x))
        ps.append(p)
    _close(torch.stack(ps), np.asarray(jidoa.idoa_run(jcfg, jg, jnp.asarray(X)))[6:])
