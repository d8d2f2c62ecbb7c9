from distantspeech_tpu_torch.doa.srp import SrpConfig, srp_angle_spectrum, srp_process, srp_steering_grid
from distantspeech_tpu_torch.doa.idoa import IdoaConfig, IdoaState, idoa_init, idoa_rtf_grid, idoa_run, idoa_step
from distantspeech_tpu_torch.doa.wpe_srp import wpe_dereverb_all, wpe_srp_process

__all__ = [
    "SrpConfig", "srp_angle_spectrum", "srp_process", "srp_steering_grid",
    "IdoaConfig", "IdoaState", "idoa_init", "idoa_step", "idoa_run", "idoa_rtf_grid",
    "wpe_dereverb_all", "wpe_srp_process",
]
