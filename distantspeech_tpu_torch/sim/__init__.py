from distantspeech_tpu_torch.sim.ism import batched_propagation, batched_rir, default_rir_length
from distantspeech_tpu_torch.sim.room import (
    RoomConfig, generate_scene, hybrid_rir, image_source_rir, sabine_rt60, simulate_propagation,
)

__all__ = [
    "RoomConfig",
    "image_source_rir",
    "sabine_rt60",
    "hybrid_rir",
    "simulate_propagation",
    "generate_scene",
    "default_rir_length",
    "batched_rir",
    "batched_propagation",
]
