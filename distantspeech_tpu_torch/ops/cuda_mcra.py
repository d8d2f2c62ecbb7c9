"""The MCRA lane kernel (``csrc/mcra.cu``): ``noise.mcra.mcra_run`` on the card.

Not a TPU kernel: the JAX package runs ``mcra_run`` as one ``lax.scan``
(``distantspeech_tpu/noise/mcra.py``).  Its plain version is
``noise.mcra.mcra_run_plain``, the per-frame loop of ``mcra_step``; the
kernel runs one thread per (lane, bin) through every frame.  The 3-tap
smoothing over bins depends on the input power alone, so it is one tensor
operation here for all frames, as ``mcra_step`` computes it per frame.

What bounds it on an H100: bytes (the power and its smoothing in, lambda_d,
p and S / Smin out, once each); ``chip_smoke.py`` computes the bound and
times it.
"""

from __future__ import annotations

import ctypes

import torch

from distantspeech_tpu_torch.ops import _build
from distantspeech_tpu_torch.ops.cuda_mvdr import _mcra_params
from distantspeech_tpu_torch.runtime.profiling import count


def _launch(cfg, Y, Sf, lam, p, sr, stream) -> int:
    """``mcra_frames``' launch into lam and p (and sr, where not None); its
    error code."""
    T = Y.shape[0]
    params = _mcra_params(cfg)
    return _build.load("mcra").mcra_launch(
        Y.data_ptr(), Sf.data_ptr(), lam.data_ptr(), p.data_ptr(), sr.data_ptr() if sr is not None else None, T,
        Y.numel() // T, Y.shape[-1], ctypes.addressof(params), stream,
    )


def mcra_frames(cfg, Y_tf: torch.Tensor, Sf: torch.Tensor, return_sr: bool = False):
    """The kernel: power Y_tf and its smoothing Sf, both [T, ..., F] float32
    CUDA tensors -> (lambda_d, p[, S / Smin]), each [T, ..., F]."""
    Y = Y_tf.contiguous()
    Sf = Sf.contiguous()
    _build.check_tensors("mcra_run", Y, Sf)
    if Y.ndim < 2 or Sf.shape != Y.shape or Y.shape[-1] != cfg.half_bin:
        raise ValueError(f"mcra_run: the power must be [T, ..., F] with F = {cfg.half_bin}, got {tuple(Y.shape)}")
    outs = [torch.empty_like(Y) for _ in range(3 if return_sr else 2)]
    err = _launch(cfg, Y, Sf, outs[0], outs[1], outs[2] if return_sr else None,
                  torch.cuda.current_stream(Y.device).cuda_stream)
    _build.check_launch("mcra", err, "mcra_run")
    count("launch.mcra_run")
    return tuple(outs)
