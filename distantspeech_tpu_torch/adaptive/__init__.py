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
]
