from distantspeech_tpu_torch.noise.mcra import McraConfig, McraState, mcra_init, mcra_run, mcra_step
from distantspeech_tpu_torch.noise.omlsa import OmlsaConfig, OmlsaState, omlsa_init, omlsa_run, omlsa_step

__all__ = [
    "McraConfig", "McraState", "mcra_init", "mcra_step", "mcra_run",
    "OmlsaConfig", "OmlsaState", "omlsa_init", "omlsa_step", "omlsa_run",
]
