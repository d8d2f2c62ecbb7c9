"""Carry configuration and state across from the JAX package.

The flagship has no learned weights: its parameters are the configs and the
steering vector (which both packages compute from the same geometry), and
its state is ``EnhanceState``.  With these two functions a run started in
``distantspeech_tpu`` can be continued here mid-utterance.  Both take plain
nested dicts of Python scalars and numpy arrays, so nothing of JAX is
imported:

- ``enhance_config_from_dict(dataclasses.asdict(jax_cfg))``;
- ``enhance_state_from_numpy(d, device)`` with ``d`` the JAX state as
  nested dicts ``{"mvdr": {"Ryy", "Rvv", "u", "mcra": {"S", "Smin",
  "Stmp", "p", "lambda_d", "ell", "frm_cnt"}}, "G_H1", "gamma"}``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, EnhanceState
from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig, MvdrState
from distantspeech_tpu_torch.noise.mcra import McraState
from distantspeech_tpu_torch.transform import StftConfig


def enhance_config_from_dict(d: Mapping[str, Any]) -> EnhanceConfig:
    mv = dict(d["mvdr"])
    mv["stft"] = StftConfig(**mv["stft"])
    return EnhanceConfig(mvdr=MvdrConfig(**mv), alpha_xi=float(d["alpha_xi"]), gmin=float(d["gmin"]))


def enhance_state_from_numpy(d: Mapping[str, Any], device=None) -> EnhanceState:
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    mv, mc = d["mvdr"], d["mvdr"]["mcra"]
    mcra = McraState(
        S=t(mc["S"]), Smin=t(mc["Smin"]), Stmp=t(mc["Stmp"]), p=t(mc["p"]), lambda_d=t(mc["lambda_d"]),
        ell=int(mc["ell"]), frm_cnt=int(mc["frm_cnt"]),
    )
    return EnhanceState(
        mvdr=MvdrState(Ryy=t(mv["Ryy"]), Rvv=t(mv["Rvv"]), u=t(mv["u"]), mcra=mcra),
        G_H1=t(d["G_H1"]),
        gamma=t(d["gamma"]),
    )
