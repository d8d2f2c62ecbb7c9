from distantspeech_tpu_torch.kws.dual_mic import DualMicKwsConfig, DualMicKwsState, kws_init, kws_process, kws_step

__all__ = ["DualMicKwsConfig", "DualMicKwsState", "kws_init", "kws_step", "kws_process"]
