"""Beamformer weight formulas, batched over frequency bins.

Counterpart of ``distantspeech_tpu/stats/weights.py``.  Every formula acts
on ``[..., F, C]`` steering vectors and ``[..., F, C, C]`` spatial matrices
in one shot.  The inverse, Cholesky and ``eigh`` of ``diag_load_inv``,
``gev_weights`` and ``pca_steering`` are ``torch.linalg``'s, as the JAX
package's are ``jnp.linalg``'s.
"""

from __future__ import annotations

import torch

from distantspeech_tpu_torch.stats.linalg import matvec, trace_mm


def _eye(R: torch.Tensor) -> torch.Tensor:
    return torch.eye(R.shape[-1], dtype=R.dtype, device=R.device)


def diag_load_inv(R: torch.Tensor, diag: float = 1e-3) -> torch.Tensor:
    """inv(R + diag * I) batched over leading axes (diagonal loading guard)."""
    return torch.linalg.inv(R + diag * _eye(R))


def mvdr_weights(steer: torch.Tensor, Rvv_inv: torch.Tensor) -> torch.Tensor:
    """w = Rvv^-1 a / (a^H Rvv^-1 a).

    steer: [..., F, C]; Rvv_inv: [..., F, C, C] -> w: [..., F, C].
    """
    num = matvec(Rvv_inv, steer)
    den = torch.sum(torch.conj(steer) * num, dim=-1)
    return num / den[..., None]


def ds_weights(steer: torch.Tensor) -> torch.Tensor:
    """Delay-and-sum: w = a / C."""
    return steer / steer.shape[-1]


def pmwf_weights(xi: torch.Tensor, Rxx: torch.Tensor, Rvv_inv: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Parameterised multichannel Wiener filter, reference channel 0.

    w = (Rvv^-1 Rxx u) / (beta + xi);  xi: [..., F] prior SNR;
    Rxx, Rvv_inv: [..., F, C, C] -> w: [..., F, C].
    """
    num = matvec(Rvv_inv, Rxx[..., :, 0])
    return num / (beta + xi)[..., None]


def tfgsc_weights(Rvv_inv: torch.Tensor, Ryy: torch.Tensor) -> torch.Tensor:
    """Frequency-domain transfer-function GSC weights (Chen, "Noncausal
    (Frequency-Domain) Optimal Filters").

    w = (Rvv^-1 Ryy - I) u / (tr(Rvv^-1 Ryy) - C), reference channel 0.
    """
    C = Ryy.shape[-1]
    num = matvec(Rvv_inv, Ryy[..., :, 0]) - _eye(Ryy)[:, 0]
    den = trace_mm(Rvv_inv, Ryy) - C
    return num / den[..., None]


def blind_analytic_normalization(w: torch.Tensor, Rvv: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """BAN distortion-reduction rescale of beamformer weights.

    w: [..., C]; Rvv: [..., C, C].
    """
    num = torch.einsum("...a,...ab,...bc,...c->...", torch.conj(w), Rvv, Rvv, w)
    num = torch.sqrt(num).abs()
    den = torch.einsum("...a,...ab,...b->...", torch.conj(w), Rvv, w).abs()
    return w * (num / (den + eps))[..., None]


def gev_weights(Rxx: torch.Tensor, Rvv: torch.Tensor) -> torch.Tensor:
    """Generalised-eigenvector (max-SNR) beamformer.

    Solves Rxx v = lambda Rvv v for the principal eigenvector, batched over
    bins, by the Cholesky whitening reduction to an ordinary Hermitian
    eigenproblem.  Each bin's vector is defined up to a unit phase, which
    another eigensolver may choose otherwise.
    """
    Li = torch.linalg.inv(torch.linalg.cholesky(Rvv))
    A = Li @ Rxx @ torch.conj(Li).transpose(-1, -2)  # whitened Li Rxx Li^H
    _, vecs = torch.linalg.eigh(A)
    v = vecs[..., :, -1]
    return torch.einsum("...ji,...j->...i", torch.conj(Li), v)  # un-whiten: w = Li^H v


def phase_correction(w: torch.Tensor) -> torch.Tensor:
    """Align beamformer-vector phase across frequency.

    Each bin is rotated so that its inner product with the already corrected
    previous bin is real-positive.  Each correction is a pure unit phase, so
    the recursion telescopes to a cumulative sum of the raw pairwise phases.

    w: [..., F, C] -> phase-corrected [..., F, C].
    """
    pair = torch.sum(w[..., 1:, :] * torch.conj(w[..., :-1, :]), dim=-1)
    theta = torch.cumsum(torch.angle(pair), dim=-1)
    theta = torch.cat([torch.zeros_like(theta[..., :1]), theta], dim=-1)
    return w * torch.exp(-1j * theta)[..., None]


def pca_steering(Rxx: torch.Tensor) -> torch.Tensor:
    """Principal eigenvector of the spatial covariance, phase-normalised to
    channel 0."""
    _, vecs = torch.linalg.eigh(Rxx)
    v = vecs[..., :, -1]
    return v / torch.exp(1j * torch.angle(v[..., :1]))
