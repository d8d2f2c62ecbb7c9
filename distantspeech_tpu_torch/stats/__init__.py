from distantspeech_tpu_torch.stats.linalg import gauss_jordan_inv, ldl_solve, matvec, trace_mm, vecmat
from distantspeech_tpu_torch.stats.psd import hermitize, rank1_update

__all__ = ["rank1_update", "hermitize", "ldl_solve", "gauss_jordan_inv", "matvec", "vecmat", "trace_mm"]
