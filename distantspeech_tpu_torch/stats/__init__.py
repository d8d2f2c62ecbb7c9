from distantspeech_tpu_torch.stats.linalg import diag_loaded_inv, gauss_jordan_inv, ldl_solve, matvec, trace_mm, vecmat
from distantspeech_tpu_torch.stats.psd import hermitize, rank1_update, update_csd, update_psd
from distantspeech_tpu_torch.stats.weights import (
    blind_analytic_normalization,
    diag_load_inv,
    ds_weights,
    gev_weights,
    mvdr_weights,
    pca_steering,
    phase_correction,
    pmwf_weights,
    tfgsc_weights,
)
from distantspeech_tpu_torch.stats.metrics import array_gain, beampattern, wng_di
from distantspeech_tpu_torch.stats.evaluation import (
    best_aligned_si_sdr,
    pesq_score,
    segmental_snr_db,
    si_sdr,
    snr_db,
    stoi_score,
)

__all__ = [
    "si_sdr",
    "best_aligned_si_sdr",
    "snr_db",
    "segmental_snr_db",
    "pesq_score",
    "stoi_score",
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
    "mvdr_weights",
    "ds_weights",
    "pmwf_weights",
    "tfgsc_weights",
    "diag_load_inv",
    "blind_analytic_normalization",
    "gev_weights",
    "phase_correction",
    "pca_steering",
    "array_gain",
    "beampattern",
    "wng_di",
]
