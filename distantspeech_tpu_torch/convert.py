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
  "G_H1", "G", "p", "frm_cnt"}, "stft_y", "stft_bm", "istft_y"}``;
- ``aec_config_from_dict`` / ``aec_state_from_numpy`` (``AecState``, its
  frame counter ``cnt`` an int), ``kws_config_from_dict`` /
  ``kws_state_from_numpy`` (``DualMicKwsState``: two FLMS states and the
  tap FIFO), ``fdgsc_config_from_dict`` / ``fdgsc_state_from_numpy``
  (``FdGscState``) and ``full_stack_config_from_dict`` /
  ``full_stack_state_from_numpy`` (``FullStackState``, with the AEC
  config nested), in the same way;
- ``subband_gsc_config_from_dict`` / ``subband_gsc_state_from_numpy``
  (``SubbandGscState``: the input-side carries and the core, whose McSpp
  state nests the McCDR's MSC and MCRA states; McSpp's ``frm_cnt`` an int)
  and ``srp_config_from_dict``;
- ``wpe_config_from_dict`` / ``wpe_state_from_numpy`` (``WpeState``: ``{"W",
  "buf", "P", "var"}``), ``subband_config_from_dict``,
  ``fixed_config_from_dict`` (its ``stft`` nested), ``pmwf_config_from_dict``;
- ``mc_mcra_config_from_dict`` / ``mc_mcra_state_from_numpy``
  (``McMcraState``: ``{"Phi_yy", "Phi_vv", "frm_cnt"}``, the counter an int),
  ``gsc_config_from_dict`` / ``gsc_state_from_numpy`` (``GscState``: ``{"G",
  "Pest", "spp"}`` with the MC-MCRA state nested),
  ``mcra2_config_from_dict`` / ``mcra2_state_from_numpy`` (``Mcra2State``:
  ``{"S", "Smin", "p", "lambda_d", "frm_cnt"}``) and
  ``idoa_config_from_dict`` / ``idoa_state_from_numpy`` (``IdoaState``:
  ``{"Y_smooth", "Y_xcorr", "mu_Delta", "mu_Delta_h0", "var_Delta_h0",
  "p"}``);
- ``binaural_config_from_dict`` / ``msc_state_from_numpy`` (``MscState``:
  ``{"Pxii", "Pxij"}``, the binaural and McCowan recursions' state),
  ``mccowan_config_from_dict``;
- ``dios_gsc_config_from_dict`` / ``dios_gsc_state_from_numpy``
  (``DiosGscState``: ``{"abm": {"Xdline", "xrefdline", "hf", "sf", "E",
  "count"}, "aic": {"Xdline", "xrefdline", "Hf", "sf"}, "fir_cache"}``, the
  ABM's segment counter an int);
- ``nlms_state_from_numpy`` (``NlmsState``: ``{"w", "buf"}``),
  ``block_lms_state_from_numpy`` (``BlockLmsState``: ``{"w", "buf", "X",
  "e", "counter"}``, the counter an int) and ``rls_state_from_numpy``
  (``RlsState``: ``{"w", "buf", "P"}``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.adaptive.aec import AecConfig, AecState
from distantspeech_tpu_torch.adaptive.feature import DcNotchState, EmphasisState
from distantspeech_tpu_torch.adaptive.flms import FlmsState
from distantspeech_tpu_torch.adaptive.nlms import BlockLmsState, NlmsState, RlsState
from distantspeech_tpu_torch.adaptive.subband import SubbandLmsState
from distantspeech_tpu_torch.beamform.dios_gsc import DiosAbmState, DiosAicState, DiosGscConfig, DiosGscState
from distantspeech_tpu_torch.beamform.enhance import EnhanceConfig, EnhanceState
from distantspeech_tpu_torch.beamform.fdgsc import FdGscConfig, FdGscState
from distantspeech_tpu_torch.beamform.fixed import FixedBeamformerConfig
from distantspeech_tpu_torch.beamform.gsc import GscConfig, GscState
from distantspeech_tpu_torch.beamform.mvdr import MvdrConfig, MvdrState
from distantspeech_tpu_torch.beamform.pmwf import PmwfConfig
from distantspeech_tpu_torch.beamform.subband_gsc import SubbandGscConfig, SubbandGscCoreState, SubbandGscState
from distantspeech_tpu_torch.beamform.tdgsc import TdGscConfig, TdGscState
from distantspeech_tpu_torch.coherence.enhance import BinauralConfig
from distantspeech_tpu_torch.coherence.msc import MscState
from distantspeech_tpu_torch.derev.wpe import WpeConfig, WpeState
from distantspeech_tpu_torch.doa.idoa import IdoaConfig, IdoaState
from distantspeech_tpu_torch.doa.srp import SrpConfig
from distantspeech_tpu_torch.kws.dual_mic import DualMicKwsConfig, DualMicKwsState
from distantspeech_tpu_torch.noise.mc_mcra import McMcraConfig, McMcraState
from distantspeech_tpu_torch.noise.mccdr import McCdrState
from distantspeech_tpu_torch.noise.mcra import McraState
from distantspeech_tpu_torch.noise.mcra2 import Mcra2Config, Mcra2State
from distantspeech_tpu_torch.noise.mcspp import McSppState
from distantspeech_tpu_torch.noise.omlsa import OmlsaState
from distantspeech_tpu_torch.postfilter.mccowan import McCowanConfig
from distantspeech_tpu_torch.runtime.full_stack import FullStackConfig, FullStackState
from distantspeech_tpu_torch.transform import StftConfig, SubbandConfig


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


def _flms_state(f: Mapping[str, Any], dev) -> FlmsState:
    t = lambda k: _tensor(f[k], dev)
    return FlmsState(buf=t("buf"), W=t("W"), P=t("P"), foreground=t("foreground"), d_delay=t("d_delay"))


def _omlsa_state(om: Mapping[str, Any], dev) -> OmlsaState:
    t = lambda k: _tensor(om[k], dev)
    return OmlsaState(mcra=_mcra_state(om["mcra"], dev), zeta_Y=t("zeta_Y"), zeta_U=t("zeta_U"),
                      lambda_d=t("lambda_d"), gamma=t("gamma"), G_H1=t("G_H1"), G=t("G"), p=t("p"),
                      frm_cnt=int(om["frm_cnt"]))


def tdgsc_state_from_numpy(d: Mapping[str, Any], device=None) -> TdGscState:
    dev = resolve_device(device)
    t = lambda k: _tensor(d[k], dev)
    return TdGscState(stft_fbf=t("stft_fbf"), mcra=_mcra_state(d["mcra"], dev), aic=_flms_state(d["aic"], dev),
                      omlsa=_omlsa_state(d["omlsa"], dev), stft_y=t("stft_y"), stft_bm=t("stft_bm"),
                      istft_y=t("istft_y"))


def aec_config_from_dict(d: Mapping[str, Any]) -> AecConfig:
    return AecConfig(**d)


def aec_state_from_numpy(d: Mapping[str, Any], device=None) -> AecState:
    dev = resolve_device(device)
    t = lambda k: _tensor(d[k], dev)
    emph = lambda e: EmphasisState(memD=_tensor(e["memD"], dev), memE=_tensor(e["memE"], dev))
    tensors = {k: t(k) for k in AecState._fields if k not in ("cnt", "emph_mic", "emph_spk")}
    return AecState(**tensors, cnt=int(d["cnt"]), emph_mic=emph(d["emph_mic"]), emph_spk=emph(d["emph_spk"]))


def kws_config_from_dict(d: Mapping[str, Any]) -> DualMicKwsConfig:
    return DualMicKwsConfig(**d)


def kws_state_from_numpy(d: Mapping[str, Any], device=None) -> DualMicKwsState:
    dev = resolve_device(device)
    return DualMicKwsState(anc=_flms_state(d["anc"], dev), cleaner=_flms_state(d["cleaner"], dev),
                           w_fifo=_tensor(d["w_fifo"], dev))


def fdgsc_config_from_dict(d: Mapping[str, Any]) -> FdGscConfig:
    return FdGscConfig(**d)


def fdgsc_state_from_numpy(d: Mapping[str, Any], device=None) -> FdGscState:
    dev = resolve_device(device)
    t = lambda k: _tensor(d[k], dev)
    return FdGscState(stft_x=t("stft_x"), mcra=_mcra_state(d["mcra"], dev), bm=_flms_state(d["bm"], dev),
                      aic=_flms_state(d["aic"], dev), delay_aligned=t("delay_aligned"), delay_fbf=t("delay_fbf"),
                      omlsa=_omlsa_state(d["omlsa"], dev), stft_y=t("stft_y"), istft_y=t("istft_y"))


def full_stack_config_from_dict(d: Mapping[str, Any]) -> FullStackConfig:
    return FullStackConfig(**{**d, "aec": aec_config_from_dict(d["aec"])})


def full_stack_state_from_numpy(d: Mapping[str, Any], device=None) -> FullStackState:
    dev = resolve_device(device)
    return FullStackState(aec=aec_state_from_numpy(d["aec"], dev), notch=DcNotchState(mem=_tensor(d["notch"]["mem"], dev)),
                          fir_cache=_tensor(d["fir_cache"], dev), gsc=tdgsc_state_from_numpy(d["gsc"], dev),
                          kws=kws_state_from_numpy(d["kws"], dev))


def subband_gsc_config_from_dict(d: Mapping[str, Any]) -> SubbandGscConfig:
    return SubbandGscConfig(**d)


def srp_config_from_dict(d: Mapping[str, Any]) -> SrpConfig:
    return SrpConfig(**d)


def _subband_lms_state(f: Mapping[str, Any], dev) -> SubbandLmsState:
    return SubbandLmsState(W=_tensor(f["W"], dev), buf=_tensor(f["buf"], dev), P=_tensor(f["P"], dev))


def _mcspp_state(sp: Mapping[str, Any], dev) -> McSppState:
    cdr = sp["mccdr"]
    msc = msc_state_from_numpy(cdr["msc"], dev)
    return McSppState(Phi_yy=_tensor(sp["Phi_yy"], dev), Phi_vv=_tensor(sp["Phi_vv"], dev),
                      mccdr=McCdrState(msc=msc, mcra=_mcra_state(cdr["mcra"], dev)), frm_cnt=int(sp["frm_cnt"]))


def subband_gsc_state_from_numpy(d: Mapping[str, Any], device=None) -> SubbandGscState:
    dev = resolve_device(device)
    t = lambda k: _tensor(d[k], dev)
    c = d["core"]
    core = SubbandGscCoreState(spp=_mcspp_state(c["spp"], dev), bm=_subband_lms_state(c["bm"], dev),
                               istft_bm=_tensor(c["istft_bm"], dev), aic=_subband_lms_state(c["aic"], dev),
                               stft_aic_x=_tensor(c["stft_aic_x"], dev), istft_aic=_tensor(c["istft_aic"], dev))
    return SubbandGscState(stft_al=t("stft_al"), stft_fbf=t("stft_fbf"), delay_fbf=t("delay_fbf"),
                           stft_fbf_d=t("stft_fbf_d"), core=core)


def wpe_config_from_dict(d: Mapping[str, Any]) -> WpeConfig:
    return WpeConfig(**d)


def wpe_state_from_numpy(d: Mapping[str, Any], device=None) -> WpeState:
    dev = resolve_device(device)
    return WpeState(**{k: _tensor(d[k], dev) for k in WpeState._fields})


def subband_config_from_dict(d: Mapping[str, Any]) -> SubbandConfig:
    return SubbandConfig(**d)


def fixed_config_from_dict(d: Mapping[str, Any]) -> FixedBeamformerConfig:
    return FixedBeamformerConfig(**{**d, "stft": StftConfig(**d["stft"])})


def pmwf_config_from_dict(d: Mapping[str, Any]) -> PmwfConfig:
    return PmwfConfig(**d)


def mc_mcra_config_from_dict(d: Mapping[str, Any]) -> McMcraConfig:
    return McMcraConfig(**d)


def mc_mcra_state_from_numpy(d: Mapping[str, Any], device=None) -> McMcraState:
    dev = resolve_device(device)
    return McMcraState(Phi_yy=_tensor(d["Phi_yy"], dev), Phi_vv=_tensor(d["Phi_vv"], dev), frm_cnt=int(d["frm_cnt"]))


def gsc_config_from_dict(d: Mapping[str, Any]) -> GscConfig:
    return GscConfig(**d)


def gsc_state_from_numpy(d: Mapping[str, Any], device=None) -> GscState:
    dev = resolve_device(device)
    return GscState(G=_tensor(d["G"], dev), Pest=_tensor(d["Pest"], dev), spp=mc_mcra_state_from_numpy(d["spp"], dev))


def mcra2_config_from_dict(d: Mapping[str, Any]) -> Mcra2Config:
    return Mcra2Config(**{**d, "b": tuple(d["b"])})


def mcra2_state_from_numpy(d: Mapping[str, Any], device=None) -> Mcra2State:
    dev = resolve_device(device)
    return Mcra2State(**{k: _tensor(d[k], dev) for k in ("S", "Smin", "p", "lambda_d")}, frm_cnt=int(d["frm_cnt"]))


def idoa_config_from_dict(d: Mapping[str, Any]) -> IdoaConfig:
    return IdoaConfig(**d)


def idoa_state_from_numpy(d: Mapping[str, Any], device=None) -> IdoaState:
    dev = resolve_device(device)
    return IdoaState(**{k: _tensor(d[k], dev) for k in IdoaState._fields})


def binaural_config_from_dict(d: Mapping[str, Any]) -> BinauralConfig:
    return BinauralConfig(**d)


def msc_state_from_numpy(d: Mapping[str, Any], device=None) -> MscState:
    dev = resolve_device(device)
    return MscState(Pxii=_tensor(d["Pxii"], dev), Pxij=_tensor(d["Pxij"], dev))


def mccowan_config_from_dict(d: Mapping[str, Any]) -> McCowanConfig:
    return McCowanConfig(**d)


def dios_gsc_config_from_dict(d: Mapping[str, Any]) -> DiosGscConfig:
    return DiosGscConfig(**d)


def dios_gsc_state_from_numpy(d: Mapping[str, Any], device=None) -> DiosGscState:
    dev = resolve_device(device)
    abm, aic = d["abm"], d["aic"]
    return DiosGscState(
        abm=DiosAbmState(**{k: _tensor(abm[k], dev) for k in ("Xdline", "xrefdline", "hf", "sf", "E")},
                         count=int(abm["count"])),
        aic=DiosAicState(**{k: _tensor(aic[k], dev) for k in DiosAicState._fields}),
        fir_cache=_tensor(d["fir_cache"], dev),
    )


def nlms_state_from_numpy(d: Mapping[str, Any], device=None) -> NlmsState:
    dev = resolve_device(device)
    return NlmsState(**{k: _tensor(d[k], dev) for k in NlmsState._fields})


def block_lms_state_from_numpy(d: Mapping[str, Any], device=None) -> BlockLmsState:
    dev = resolve_device(device)
    return BlockLmsState(**{k: _tensor(d[k], dev) for k in ("w", "buf", "X", "e")}, counter=int(d["counter"]))


def rls_state_from_numpy(d: Mapping[str, Any], device=None) -> RlsState:
    dev = resolve_device(device)
    return RlsState(**{k: _tensor(d[k], dev) for k in RlsState._fields})
