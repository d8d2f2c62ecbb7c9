from distantspeech_tpu_torch.ops.framing import frame_signal, overlap_add

__all__ = ["frame_signal", "overlap_add"]
