from distantspeech_tpu_torch.doa.srp import SrpConfig, srp_angle_spectrum, srp_process, srp_steering_grid

__all__ = ["SrpConfig", "srp_angle_spectrum", "srp_process", "srp_steering_grid"]
