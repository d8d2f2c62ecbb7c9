from distantspeech_tpu_torch.transform.stft import (
    StftConfig,
    analysis,
    istft_frames,
    istft_stream,
    magphase,
    sqrt_hann_window,
    stft_frames,
    stft_init_carry,
    stft_stream,
    synthesis,
)
from distantspeech_tpu_torch.transform.filterbank_design import (
    design_analysis_prototype,
    design_synthesis_prototype,
    nyquist_prototypes,
)
from distantspeech_tpu_torch.transform.subband import (
    SubbandConfig,
    subband_analysis,
    subband_analysis_frames,
    subband_analysis_stream,
    subband_synthesis,
    subband_synthesis_init,
    subband_synthesis_step,
)

__all__ = [
    "StftConfig",
    "sqrt_hann_window",
    "stft_frames",
    "istft_frames",
    "analysis",
    "synthesis",
    "stft_stream",
    "istft_stream",
    "stft_init_carry",
    "magphase",
    "SubbandConfig",
    "subband_analysis",
    "subband_analysis_frames",
    "subband_analysis_stream",
    "subband_synthesis",
    "subband_synthesis_init",
    "subband_synthesis_step",
    "design_analysis_prototype",
    "design_synthesis_prototype",
    "nyquist_prototypes",
]
