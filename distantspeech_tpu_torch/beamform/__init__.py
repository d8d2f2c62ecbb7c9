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
from distantspeech_tpu_torch.beamform.gsc_filters import aic_step, bm_bounds, bm_step
from distantspeech_tpu_torch.beamform.fdgsc import FdGscConfig, FdGscState, fdgsc_init, fdgsc_process, fdgsc_step
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
    "aic_step",
    "bm_bounds",
    "bm_step",
    "FdGscConfig",
    "FdGscState",
    "fdgsc_init",
    "fdgsc_step",
    "fdgsc_process",
]
