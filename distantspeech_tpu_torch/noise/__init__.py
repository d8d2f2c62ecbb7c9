from distantspeech_tpu_torch.noise.mcra import McraConfig, McraState, mcra_init, mcra_run, mcra_step

__all__ = ["McraConfig", "McraState", "mcra_init", "mcra_step", "mcra_run"]
