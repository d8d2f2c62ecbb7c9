"""Kernel K10: the fused SRP-PHAT angle spectrum.

Counterpart of ``distantspeech_tpu/ops/pallas_srp.py``: the CUDA kernel of
``csrc/srp.cu`` replaces the Pallas kernel ``_srp_kernel`` (called by
``fused_srp_spectrum``).  For every row r (a frame of an utterance) and
angle theta it computes out[r, theta] = sum_f |sum_m conj(a_theta,f,m)
yw_r,f,m| over the whitened spectrum yw, as one real product per bin
against the packed conjugate steering grid, so the [rows, Theta, F] steered
field never reaches device memory.

The PHAT whitening Y / (|Y| + 1e-6) (``phat_whiten``, which the einsum path
shares) and the grid packing stay in the wrapper, as in JAX; the TPU's
128-multiple angle padding and its row tiling are dropped.
``srp_spectrum`` runs the product: on a CPU tensor its plain version
``srp_spectrum_plain`` (the per-bin packed product in PyTorch), on a CUDA
tensor the kernel (or it raises).
"""

from __future__ import annotations

import ctypes

import torch

from distantspeech_tpu_torch._device import wrapper_input
from distantspeech_tpu_torch.ops import _build

LAUNCHES = {"fused_srp_spectrum": 0}


def pack_grid(grid, device) -> torch.Tensor:
    """[Theta, F, M] complex steering grid -> G [F, 2M, 2 Theta] float32 on
    ``device``, so that [yr | yi] @ G[f] = [Re | Im] of sum_m conj(a_m) y_m:
    G = [[Gr, -Gi], [Gi, Gr]].  The packing runs on the device."""
    g = torch.as_tensor(grid, device=device)
    Gr, Gi = (a.permute(1, 2, 0).to(torch.float32) for a in (g.real, g.imag))  # [F, M, Theta]
    # re(a* y) = Gr yr + Gi yi, im(a* y) = Gr yi - Gi yr
    return torch.cat([torch.cat([Gr, -Gi], dim=2), torch.cat([Gi, Gr], dim=2)], dim=1).contiguous()


def phat_whiten(Y: torch.Tensor) -> torch.Tensor:
    """The PHAT whitening of a complex spectrum: Y / (|Y| + 1e-6)."""
    return Y / (Y.abs() + 1e-6)


def whitened_rows(Y_tfm: torch.Tensor, phat: bool = True) -> torch.Tensor:
    """[..., F, M] complex -> y2 [n, F, 2M] float32 rows [re | im], PHAT
    whitened when ``phat``."""
    Yw = phat_whiten(Y_tfm) if phat else Y_tfm
    F, M = Y_tfm.shape[-2:]
    return torch.cat([Yw.real, Yw.imag], dim=-1).reshape(-1, F, 2 * M).to(torch.float32)


def srp_spectrum_plain(y2: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """Plain version of the K10 kernel: y2 [R, F, 2M], G [F, 2M, 2 Theta]
    -> [R, Theta] = sum_f |y2[:, f] @ G[f]| (a complex magnitude of the
    [Re | Im] halves), in float32."""
    Theta = G.shape[-1] // 2
    acc = y2.new_zeros((y2.shape[0], Theta))
    for f in range(y2.shape[1]):
        z = y2[:, f] @ G[f]
        acc = acc + torch.sqrt(z[:, :Theta] ** 2 + z[:, Theta:] ** 2)
    return acc


def _library() -> ctypes.CDLL:
    lib = _build.load("srp")
    if not getattr(lib, "_signatures_set", False):
        lib.fused_srp_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.fused_srp_launch.restype = ctypes.c_int
        lib._signatures_set = True
    return lib


def srp_spectrum(y2: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """The K10 kernel: ``srp_spectrum_plain``'s product.  CPU tensors run
    ``srp_spectrum_plain``; CUDA tensors launch the kernel (float32,
    contiguous) or raise."""
    if y2.device.type == "cpu":
        return srp_spectrum_plain(y2, G)
    _build.check_tensors("fused_srp_spectrum", y2, G)
    R, F, M2 = y2.shape
    if G.ndim != 3 or G.shape[:2] != (F, M2) or G.shape[2] % 2:
        raise ValueError(f"fused_srp_spectrum: G must be [F={F}, 2M={M2}, 2 Theta], got {tuple(G.shape)}")
    if M2 // 2 not in range(2, 9):
        raise ValueError(f"fused_srp_spectrum: the kernel is built for M from 2 to 8, got {M2 // 2}")
    Theta = G.shape[2] // 2
    out = torch.empty((R, Theta), dtype=torch.float32, device=y2.device)
    err = _library().fused_srp_launch(
        y2.data_ptr(), G.data_ptr(), out.data_ptr(), R, F, M2 // 2, Theta,
        torch.cuda.current_stream(y2.device).cuda_stream,
    )
    _build.check_launch("srp", err, "fused_srp_spectrum")
    LAUNCHES["fused_srp_spectrum"] += 1
    return out


def fused_srp_spectrum(Y_tfm, grid, phat: bool = True) -> torch.Tensor:
    """Angle spectrum of a spectrogram, fused.  Y_tfm: [T, ..., F, M]
    complex; grid: [Theta, F, M] complex.  Returns [T, ..., Theta] float32,
    ``doa.srp.srp_angle_spectrum`` to float32 rounding.  A tensor stays on
    its device; other inputs go to the card."""
    Y_tfm = wrapper_input(Y_tfm)
    G = pack_grid(grid, Y_tfm.device)
    out = srp_spectrum(whitened_rows(Y_tfm, phat).contiguous(), G)
    return out.reshape(*Y_tfm.shape[:-2], G.shape[-1] // 2)
