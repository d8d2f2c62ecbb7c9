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

LAUNCHES = {"mcra_run": 0}


def _library() -> ctypes.CDLL:
    lib = _build.load("mcra")
    if not getattr(lib, "_signatures_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mcra_launch.argtypes = [p, p, p, p, p, i, i, i, p, p]
        lib.mcra_launch.restype = i
        lib._signatures_set = True
    return lib


def mcra_frames(cfg, Y_tf: torch.Tensor, Sf: torch.Tensor, return_sr: bool = False):
    """The kernel: power Y_tf and its smoothing Sf, both [T, ..., F] float32
    CUDA tensors -> (lambda_d, p[, S / Smin]), each [T, ..., F]."""
    Y = Y_tf.contiguous()
    Sf = Sf.contiguous()
    _build.check_tensors("mcra_run", Y, Sf)
    if Y.ndim < 2 or Sf.shape != Y.shape or Y.shape[-1] != cfg.half_bin:
        raise ValueError(f"mcra_run: the power must be [T, ..., F] with F = {cfg.half_bin}, got {tuple(Y.shape)}")
    T, F = Y.shape[0], Y.shape[-1]
    NL = Y.numel() // T
    outs = [torch.empty_like(Y) for _ in range(3 if return_sr else 2)]
    params = _mcra_params(cfg)
    err = _library().mcra_launch(
        Y.data_ptr(), Sf.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
        outs[2].data_ptr() if return_sr else None, T, NL, F, ctypes.addressof(params),
        torch.cuda.current_stream(Y.device).cuda_stream,
    )
    _build.check_launch("mcra", err, "mcra_run")
    LAUNCHES["mcra_run"] += 1
    return tuple(outs)
