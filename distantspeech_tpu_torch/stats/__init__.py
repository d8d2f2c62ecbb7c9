from distantspeech_tpu_torch.stats.linalg import diag_loaded_inv, gauss_jordan_inv, ldl_solve, matvec, trace_mm, vecmat
from distantspeech_tpu_torch.stats.psd import hermitize, rank1_update, update_csd, update_psd

__all__ = [
    "update_psd",
    "update_csd",
    "rank1_update",
    "hermitize",
    "ldl_solve",
    "gauss_jordan_inv",
    "diag_loaded_inv",
    "matvec",
    "vecmat",
    "trace_mm",
]
