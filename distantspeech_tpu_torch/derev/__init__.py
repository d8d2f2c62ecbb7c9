from distantspeech_tpu_torch.derev.wpe import WpeConfig, WpeState, wpe_init, wpe_process, wpe_run, wpe_step

__all__ = ["WpeConfig", "WpeState", "wpe_init", "wpe_step", "wpe_run", "wpe_process"]
