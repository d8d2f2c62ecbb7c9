"""WPE dereverberation of every channel followed by SRP-PHAT DOA.

BASELINE config 4, as the JAX package's pipeline benchmark defines it
(``benchmarks/pipelines.py``, ``wpe_srp_8mic`` and ``wpe_srp_fused_8mic``):
the subband analysis of each mic, the RLS-WPE recursion over all channels,
the subband synthesis of every channel's prediction error, then
``doa.srp.srp_process`` on the dereverberated signals.  With
``backend="fused"`` the SRP spectrum is kernel K10; the MCRA track beside
it is the MCRA lane kernel on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.array.geometry import ArrayGeometry
from distantspeech_tpu_torch.derev.wpe import WpeConfig, wpe_run
from distantspeech_tpu_torch.doa.srp import SrpConfig, srp_process
from distantspeech_tpu_torch.transform.subband import subband_analysis, subband_synthesis


def wpe_analysis(x: torch.Tensor, cfg: WpeConfig) -> torch.Tensor:
    """The subband analysis of every channel in ``wpe_run``'s layout.
    x: [..., C, S] -> D: [T, ..., F, C]."""
    Y = subband_analysis(x, cfg.subband)  # [..., C, T, F]
    return torch.movedim(torch.movedim(Y, -3, -1), -3, 0)


def wpe_synthesis(e: torch.Tensor, cfg: WpeConfig) -> torch.Tensor:
    """The subband synthesis of ``wpe_run``'s prediction error.
    e: [T, ..., F, C] -> [..., C, S]."""
    return subband_synthesis(torch.movedim(e, 0, -2).transpose(-1, -3), cfg.subband)  # [..., C, T, F] in


def wpe_dereverb_all(x: torch.Tensor, cfg: WpeConfig) -> torch.Tensor:
    """WPE of every channel.  x: [..., C, S] -> [..., C, S]: each channel's
    prediction error through the subband synthesis.  Each stage is a
    ``torch.profiler`` range (``wpe_srp.analysis``, ``.wpe``, ``.synthesis``)."""
    with record_function("wpe_srp.analysis"):
        D = wpe_analysis(x, cfg)
    with record_function("wpe_srp.wpe"):
        e = wpe_run(cfg, D)
    with record_function("wpe_srp.synthesis"):
        return wpe_synthesis(e, cfg)


def wpe_srp_process(
    x, geometry: ArrayGeometry, wpe_cfg: Optional[WpeConfig] = None, srp_cfg: SrpConfig = SrpConfig(),
    phat: bool = True, backend: str = "scan", device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [..., M, S] -> (angle_spectrum [..., T, Theta], p [..., T, F]) of
    the dereverberated signals, on ``device``.  ``wpe_cfg`` defaults to
    ``WpeConfig(n_channels=geometry.n_mics)``; ``backend`` is
    ``srp_process``'s ('scan' or 'fused')."""
    x = torch.as_tensor(x, device=resolve_device(device))
    cfg = wpe_cfg or WpeConfig(n_channels=geometry.n_mics)
    y = wpe_dereverb_all(x, cfg)
    with record_function("wpe_srp.srp"):
        return srp_process(y, geometry, srp_cfg, phat=phat, backend=backend, device=x.device)
