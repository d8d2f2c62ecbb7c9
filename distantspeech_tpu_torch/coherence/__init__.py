from distantspeech_tpu_torch.coherence.msc import MscState, msc_init, msc_update, pair_index, pair_indices
from distantspeech_tpu_torch.coherence.weights import coherent_gain

__all__ = ["MscState", "msc_init", "msc_update", "pair_index", "pair_indices", "coherent_gain"]
