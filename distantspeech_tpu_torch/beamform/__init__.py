from distantspeech_tpu_torch.beamform.enhance import (
    EnhanceConfig,
    EnhanceState,
    enhance_init,
    enhance_process,
    enhance_scan,
    enhance_scan_pallas,
    enhance_step,
)
from distantspeech_tpu_torch.beamform.tdgsc import (
    TdGscConfig,
    TdGscState,
    tdgsc_init,
    tdgsc_process,
    tdgsc_step,
)
from distantspeech_tpu_torch.beamform.mvdr import (
    MvdrConfig,
    MvdrState,
    mvdr_init,
    mvdr_process,
    mvdr_scan,
    mvdr_step,
)

__all__ = [
    "EnhanceConfig",
    "EnhanceState",
    "enhance_init",
    "enhance_step",
    "enhance_scan",
    "enhance_scan_pallas",
    "enhance_process",
    "MvdrConfig",
    "MvdrState",
    "mvdr_init",
    "mvdr_step",
    "mvdr_scan",
    "mvdr_process",
    "TdGscConfig",
    "TdGscState",
    "tdgsc_init",
    "tdgsc_step",
    "tdgsc_process",
]
