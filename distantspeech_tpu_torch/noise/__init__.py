from distantspeech_tpu_torch.noise.mcra import McraConfig, McraState, mcra_init, mcra_run, mcra_step
from distantspeech_tpu_torch.noise.mcra2 import Mcra2Config, Mcra2State, mcra2_init, mcra2_run, mcra2_step
from distantspeech_tpu_torch.noise.mc_mcra import McMcraConfig, McMcraOut, McMcraState, mc_mcra_init, mc_mcra_run, mc_mcra_step
from distantspeech_tpu_torch.noise.omlsa import OmlsaConfig, OmlsaState, omlsa_init, omlsa_run, omlsa_step
from distantspeech_tpu_torch.noise.mccdr import McCdrConfig, McCdrState, mccdr_init, mccdr_step
from distantspeech_tpu_torch.noise.mcspp_base import (
    McSppBaseConfig,
    McSppBaseState,
    McSppOut,
    mcspp_base_init,
    mcspp_base_run,
    mcspp_base_step,
)
from distantspeech_tpu_torch.noise.mcspp import McSppConfig, McSppState, mcspp_init, mcspp_run, mcspp_step

__all__ = [
    "McraConfig", "McraState", "mcra_init", "mcra_step", "mcra_run",
    "Mcra2Config", "Mcra2State", "mcra2_init", "mcra2_step", "mcra2_run",
    "McMcraConfig", "McMcraOut", "McMcraState", "mc_mcra_init", "mc_mcra_step", "mc_mcra_run",
    "OmlsaConfig", "OmlsaState", "omlsa_init", "omlsa_step", "omlsa_run",
    "McCdrConfig", "McCdrState", "mccdr_init", "mccdr_step",
    "McSppBaseConfig", "McSppBaseState", "McSppOut", "mcspp_base_init", "mcspp_base_step", "mcspp_base_run",
    "McSppConfig", "McSppState", "mcspp_init", "mcspp_step", "mcspp_run",
]
