"""Time-domain sample-serial adaptive filters: (N)LMS, block LMS, RLS.

Counterpart of ``distantspeech_tpu/adaptive/nlms.py``.  Each recursion is
serial by definition (each sample's gradient uses the weights the previous
sample updated), so the offline entry points loop over samples; any number of
independent filters batch over the leading axes.  The block LMS counter is
a host int: the weights update only on the samples where it wraps (the
same numbers as computing the update every sample and selecting).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.stats.linalg import matvec, vecmat


def awgn(x, snr: float, seed: int = 7):
    """Add white Gaussian noise at a given SNR in dB, from the legacy NumPy
    generator (so the same seed gives the same noise as the JAX package's).
    Host-side test and demo utility; x: [N] numpy array."""
    rs = np.random.RandomState(seed)
    lin = 10.0 ** (snr / 10.0)
    xpower = np.sum(np.asarray(x) ** 2) / len(x)
    noise = rs.randn(len(x)) * np.sqrt(xpower / lin)
    return np.asarray(x) + noise


def _shift_in(buf: torch.Tensor, x_n: torch.Tensor) -> torch.Tensor:
    """The shift register with x_n pushed in front (newest first)."""
    return torch.cat([x_n[..., None], buf[..., :-1]], dim=-1)


class NlmsState(NamedTuple):
    w: torch.Tensor  # [..., L]
    buf: torch.Tensor  # input shift register [..., L], newest first


def nlms_init(filter_len: int, batch_shape=(), dtype=torch.float32, device=None) -> NlmsState:
    z = torch.zeros((*batch_shape, filter_len), dtype=dtype, device=resolve_device(device))
    return NlmsState(w=z, buf=z)


def nlms_step(
    state: NlmsState, x_n: torch.Tensor, d_n: torch.Tensor, mu: float = 0.1,
    eps: float = 1e-4, p=1.0, normalize: bool = True,
) -> Tuple[NlmsState, torch.Tensor]:
    """One sample of (N)LMS.  x_n, d_n: [...] scalars per batch element."""
    buf = _shift_in(state.buf, x_n)
    err = d_n - torch.sum(state.w * buf, dim=-1)
    if normalize:
        grad = buf * err[..., None] / (torch.sum(buf * buf, dim=-1) + eps)[..., None]
    else:
        grad = buf * err[..., None]
    w = state.w + 2.0 * p * mu * grad
    return NlmsState(w=w, buf=buf), err


def nlms_filter(x, d, filter_len: int, mu: float = 0.1, normalize: bool = True, device=None):
    """Run (N)LMS over whole signals.  x, d: [..., N] (time axis last).
    Returns (err [..., N], w [..., L]) on ``device``."""
    dev = resolve_device(device)
    x, d = torch.as_tensor(x, device=dev), torch.as_tensor(d, device=dev)
    state = nlms_init(filter_len, batch_shape=x.shape[:-1], dtype=x.dtype, device=dev)
    errs = []
    for x_n, d_n in zip(x.unbind(-1), d.unbind(-1)):
        state, err = nlms_step(state, x_n, d_n, mu=mu, normalize=normalize)
        errs.append(err)
    return torch.stack(errs, dim=-1), state.w


class BlockLmsState(NamedTuple):
    w: torch.Tensor  # [..., L]
    buf: torch.Tensor  # input shift register  [..., L]
    X: torch.Tensor  # block input matrix      [..., B, L], newest row first
    e: torch.Tensor  # block error vector      [..., B]
    counter: int  # samples since the last update (host int)


def block_lms_init(filter_len: int, block_len: int, batch_shape=(), dtype=torch.float32, device=None) -> BlockLmsState:
    dev = resolve_device(device)
    z = torch.zeros((*batch_shape, filter_len), dtype=dtype, device=dev)
    return BlockLmsState(
        w=z,
        buf=z,
        X=torch.zeros((*batch_shape, block_len, filter_len), dtype=dtype, device=dev),
        e=torch.zeros((*batch_shape, block_len), dtype=dtype, device=dev),
        counter=0,
    )


def block_lms_step(
    state: BlockLmsState, x_n: torch.Tensor, d_n: torch.Tensor, mu: float = 0.1, alpha: float = 1e-4
) -> Tuple[BlockLmsState, torch.Tensor]:
    """One sample of block LMS: the weights update every block_len samples."""
    B = state.e.shape[-1]
    buf = _shift_in(state.buf, x_n)
    X = torch.cat([buf[..., None, :], state.X[..., :-1, :]], dim=-2)
    en = d_n - torch.sum(state.w * buf, dim=-1)
    e = torch.cat([en[..., None], state.e[..., :-1]], dim=-1)
    w, counter = state.w, state.counter
    if counter % B == 0:
        norm = torch.sum(X**2, dim=-1) + alpha  # [..., B]
        grad = torch.sum(X * (e / norm)[..., :, None], dim=-2)
        w, counter = w + 2.0 * mu * grad, 0
    return BlockLmsState(w=w, buf=buf, X=X, e=e, counter=counter + 1), en


class RlsState(NamedTuple):
    w: torch.Tensor  # [..., L]
    buf: torch.Tensor  # [..., L]
    P: torch.Tensor  # inverse correlation [..., L, L]


def rls_init(filter_len: int, delta: float = 1e-3, batch_shape=(), dtype=torch.float32, device=None) -> RlsState:
    dev = resolve_device(device)
    z = torch.zeros((*batch_shape, filter_len), dtype=dtype, device=dev)
    P = (torch.eye(filter_len, dtype=dtype, device=dev) / delta).expand(*batch_shape, filter_len, filter_len).clone()
    return RlsState(w=z, buf=z, P=P)


def rls_step(
    state: RlsState, x_n: torch.Tensor, d_n: torch.Tensor, mu: float = 0.5, lam: float = 0.9998
) -> Tuple[RlsState, torch.Tensor]:
    """One RLS sample (the gradient is scaled by 2 mu, so mu = 0.5 gives the
    textbook recursion)."""
    buf = _shift_in(state.buf, x_n)
    err = d_n - torch.sum(state.w * buf, dim=-1)
    num = matvec(state.P, buf)  # P u
    kn = num / (lam + torch.sum(buf * num, dim=-1))[..., None]
    row = vecmat(buf, state.P)  # u^T P (no symmetry assumed)
    P = (state.P - kn[..., :, None] * row[..., None, :]) / lam
    w = state.w + 2.0 * mu * err[..., None] * kn
    return RlsState(w=w, buf=buf, P=P), err


def rls_filter(x, d, filter_len: int, mu: float = 0.5, lam: float = 0.9998, device=None):
    """Run RLS over whole signals, time axis last.  Returns (err [..., N],
    w [..., L]) on ``device``."""
    dev = resolve_device(device)
    x, d = torch.as_tensor(x, device=dev), torch.as_tensor(d, device=dev)
    state = rls_init(filter_len, batch_shape=x.shape[:-1], dtype=x.dtype, device=dev)
    errs = []
    for x_n, d_n in zip(x.unbind(-1), d.unbind(-1)):
        state, err = rls_step(state, x_n, d_n, mu=mu, lam=lam)
        errs.append(err)
    return torch.stack(errs, dim=-1), state.w
