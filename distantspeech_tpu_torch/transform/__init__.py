from distantspeech_tpu_torch.transform.stft import (
    StftConfig,
    analysis,
    istft_frames,
    istft_stream,
    sqrt_hann_window,
    stft_frames,
    stft_init_carry,
    stft_stream,
    synthesis,
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
]
