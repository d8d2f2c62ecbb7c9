from distantspeech_tpu_torch.coherence.msc import MscState, msc_init, msc_update, pair_index, pair_indices

__all__ = ["MscState", "msc_init", "msc_update", "pair_index", "pair_indices"]
