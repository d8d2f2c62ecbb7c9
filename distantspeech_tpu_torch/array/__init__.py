from distantspeech_tpu_torch.array.alignment import fractional_delay_filter_bank, time_alignment_filters
from distantspeech_tpu_torch.array.coherence import diffuse_coherence
from distantspeech_tpu_torch.array.geometry import (
    ArrayGeometry,
    cart2sph,
    circular_array,
    linear_array,
    sph2cart,
)
from distantspeech_tpu_torch.array.steering import compute_tau, omega_bins, steering_vector

__all__ = [
    "ArrayGeometry",
    "cart2sph",
    "sph2cart",
    "linear_array",
    "circular_array",
    "compute_tau",
    "omega_bins",
    "steering_vector",
    "fractional_delay_filter_bank",
    "time_alignment_filters",
    "diffuse_coherence",
]
