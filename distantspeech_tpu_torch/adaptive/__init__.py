from distantspeech_tpu_torch.adaptive.feature import (
    DcNotchState,
    EmphasisState,
    dc_notch,
    dc_notch_init,
    de_emphasis,
    emphasis_init,
    pre_emphasis,
)
from distantspeech_tpu_torch.adaptive.flms import FlmsConfig, FlmsState, flms_init, flms_set_weights, flms_step
from distantspeech_tpu_torch.adaptive.aec import AecConfig, AecState, aec_init, aec_step
from distantspeech_tpu_torch.adaptive.mdf import MdfConfig, MdfState, mdf_adjust_prop, mdf_init, mdf_step
from distantspeech_tpu_torch.adaptive.subband import (
    SubbandAfConfig,
    SubbandLmsState,
    SubbandRlsState,
    subband_lms_init,
    subband_lms_mc_step,
    subband_lms_step,
    subband_rls_init,
    subband_rls_step,
)

__all__ = [
    "EmphasisState",
    "emphasis_init",
    "pre_emphasis",
    "de_emphasis",
    "DcNotchState",
    "dc_notch_init",
    "dc_notch",
    "FlmsConfig",
    "FlmsState",
    "flms_init",
    "flms_set_weights",
    "flms_step",
    "AecConfig",
    "AecState",
    "aec_init",
    "aec_step",
    "MdfConfig",
    "MdfState",
    "mdf_adjust_prop",
    "mdf_init",
    "mdf_step",
    "SubbandAfConfig",
    "SubbandLmsState",
    "SubbandRlsState",
    "subband_lms_init",
    "subband_lms_step",
    "subband_lms_mc_step",
    "subband_rls_init",
    "subband_rls_step",
]
