"""Carry configuration and state across from the JAX package.

The ported pipelines have no learned weights: their parameters are the
configs and the steering or alignment filters (which both packages compute
from the same geometry), and their state is a NamedTuple of arrays.  With
these functions a run started in ``distantspeech_tpu`` can be continued
here mid-utterance.  They take plain nested dicts of Python scalars and
numpy arrays (a JAX state as ``{field: value}``, recursively), so nothing
of JAX is imported:

- ``enhance_config_from_dict(dataclasses.asdict(jax_cfg))``;
- ``enhance_state_from_numpy(d, device)`` with ``d`` the JAX
  ``EnhanceState``: ``{"mvdr": {"Ryy", "Rvv", "u", "mcra": {"S", "Smin",
  "Stmp", "p", "lambda_d", "ell", "frm_cnt"}}, "G_H1", "gamma"}``;
- ``tdgsc_config_from_dict(dataclasses.asdict(jax_cfg))``;
- ``tdgsc_state_from_numpy(d, device)`` with ``d`` the JAX ``TdGscState``:
  ``{"stft_fbf", "mcra", "aic": {"buf", "W", "P", "foreground",
  "d_delay"}, "omlsa": {"mcra", "zeta_Y", "zeta_U", "lambda_d", "gamma",
  "G_H1", "G", "p", "frm_cnt"}, "stft_y", "stft_bm", "istft_y"}``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.adaptive.flms import FlmsState
from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, EnhanceState
from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig, MvdrState
from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig, TdGscState
from distantspeech_tpu_torch.noise.mcra import McraState
from distantspeech_tpu_torch.noise.omlsa import OmlsaState
from distantspeech_tpu_torch.transform import StftConfig


def enhance_config_from_dict(d: Mapping[str, Any]) -> EnhanceConfig:
    mv = dict(d["mvdr"])
    mv["stft"] = StftConfig(**mv["stft"])
    return EnhanceConfig(mvdr=MvdrConfig(**mv), alpha_xi=float(d["alpha_xi"]), gmin=float(d["gmin"]))


def _tensor(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=dev)  # a copy: JAX's arrays are read-only


def _mcra_state(mc: Mapping[str, Any], dev) -> McraState:
    t = lambda k: _tensor(mc[k], dev)
    return McraState(S=t("S"), Smin=t("Smin"), Stmp=t("Stmp"), p=t("p"), lambda_d=t("lambda_d"),
                     ell=int(mc["ell"]), frm_cnt=int(mc["frm_cnt"]))


def enhance_state_from_numpy(d: Mapping[str, Any], device=None) -> EnhanceState:
    dev = resolve_device(device)
    mv = d["mvdr"]
    t = lambda a: _tensor(a, dev)
    return EnhanceState(
        mvdr=MvdrState(Ryy=t(mv["Ryy"]), Rvv=t(mv["Rvv"]), u=t(mv["u"]), mcra=_mcra_state(mv["mcra"], dev)),
        G_H1=t(d["G_H1"]),
        gamma=t(d["gamma"]),
    )


def tdgsc_config_from_dict(d: Mapping[str, Any]) -> TdGscConfig:
    return TdGscConfig(**d)


def tdgsc_state_from_numpy(d: Mapping[str, Any], device=None) -> TdGscState:
    dev = resolve_device(device)
    t = lambda a: _tensor(a, dev)
    aic, om = d["aic"], d["omlsa"]
    return TdGscState(
        stft_fbf=t(d["stft_fbf"]),
        mcra=_mcra_state(d["mcra"], dev),
        aic=FlmsState(buf=t(aic["buf"]), W=t(aic["W"]), P=t(aic["P"]), foreground=t(aic["foreground"]),
                      d_delay=t(aic["d_delay"])),
        omlsa=OmlsaState(mcra=_mcra_state(om["mcra"], dev), zeta_Y=t(om["zeta_Y"]), zeta_U=t(om["zeta_U"]),
                         lambda_d=t(om["lambda_d"]), gamma=t(om["gamma"]), G_H1=t(om["G_H1"]), G=t(om["G"]),
                         p=t(om["p"]), frm_cnt=int(om["frm_cnt"])),
        stft_y=t(d["stft_y"]),
        stft_bm=t(d["stft_bm"]),
        istft_y=t(d["istft_y"]),
    )
