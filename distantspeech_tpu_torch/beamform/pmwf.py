"""Online PMWF beamformer driven by the MC-SPP noise tracker.

Counterpart of ``distantspeech_tpu/beamform/pmwf.py``: the Souden SPP
tracker (``noise.mcspp``, CDR-driven, or ``noise.mcspp_base``,
MCRA-driven) estimates Phi_vv / Phi_xx online, its parameterised
multichannel Wiener weights are applied to the input spectra, optionally
with the OM-LSA gain on top.
"""

from __future__ import annotations

import dataclasses

import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.noise.mcspp import McSppConfig, mcspp_init, mcspp_step
from distantspeech_tpu_torch.noise.mcspp_base import McSppBaseConfig, mcspp_base_init, mcspp_base_step
from distantspeech_tpu_torch.transform import StftConfig, analysis, synthesis


@dataclasses.dataclass(frozen=True)
class PmwfConfig:
    n_mics: int = 4
    frame_len: int = 256
    full: bool = True  # McSpp (CDR-driven) vs McSppBase (MCRA-driven)
    omlsa_gain: bool = True
    gmin: float = 0.0631

    @property
    def stft(self) -> StftConfig:
        return StftConfig(self.frame_len, self.frame_len // 2)


def pmwf_process(x, geometry: ArrayGeometry, cfg: PmwfConfig = PmwfConfig(), device=None) -> torch.Tensor:
    """Offline PMWF enhancement.  x: [..., M, S] -> [..., S] on ``device``.
    ``geometry`` is not read (the trackers assume their own arrays), as in
    the JAX package."""
    x = torch.as_tensor(x, device=resolve_device(device))
    X = analysis(x, cfg.stft)  # [..., M, T, F]
    Zt = torch.movedim(torch.movedim(X, -3, -1), -3, 0)  # [T, ..., F, M]
    batch = Zt.shape[1:-2]

    if cfg.full:
        scfg = McSppConfig(nfft=cfg.frame_len, n_channels=cfg.n_mics)
        Fn = torch.as_tensor(scfg.mccdr.fn_pair(), dtype=x.dtype, device=x.device)
        state = mcspp_init(scfg, batch_shape=batch, cdtype=Zt.dtype, device=x.device)
        step = lambda s, z: mcspp_step(scfg, Fn, s, z)
    else:
        scfg = McSppBaseConfig(nfft=cfg.frame_len, n_channels=cfg.n_mics)
        state = mcspp_base_init(scfg, batch_shape=batch, cdtype=Zt.dtype, device=x.device)
        step = lambda s, z: mcspp_base_step(scfg, s, z)

    Y = []
    for z in Zt:
        state, out = step(state, z)
        y = torch.sum(torch.conj(out.w) * z, dim=-1)
        if cfg.omlsa_gain:
            G_H1 = out.xi / (1.0 + out.xi)
            y = y * torch.clamp(G_H1**out.p * cfg.gmin ** (1.0 - out.p), cfg.gmin, 1.0)
        Y.append(y)
    return synthesis(torch.stack(Y, dim=-2), cfg.stft)
