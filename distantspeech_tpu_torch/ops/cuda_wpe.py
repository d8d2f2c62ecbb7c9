"""WPE's RLS recursion on the card (``csrc/wpe.cu``): ``derev.wpe.wpe_run``.

Not a TPU kernel: the JAX package runs ``wpe_run`` as one ``lax.scan`` of
``wpe_step`` (``distantspeech_tpu/derev/wpe.py``) and has no Pallas kernel
for it.  Its plain version is ``derev.wpe._recursion``, the frame loop of
``wpe_step``; the kernel steps each (utterance, bin) state through every
frame on chip, P's Hermitian half in registers, from one launch.

The range (``check_input``): C channels times ``filter_len`` taps from 1 to
160, at most 32 channels, a delay of at least 1 and delay + filter_len at
most 200, complex64 spectra [T, ..., F, C].  Outside it the wrapper raises
before any launch; a CUDA tensor never falls back to the frame loop.

What bounds it on an H100: operations (``portbench/roofline/wpe.py``'s
count, 1.35 ms at ``reverb8.wpe_srp.b8``); ``chip_smoke.py`` times it
beside that bound and the frame loop.
"""

from __future__ import annotations

import ctypes

import torch

from distantspeech_tpu_torch.ops import _build
from distantspeech_tpu_torch.runtime.profiling import count

MAX_TAPS = 160  # C * filter_len
MAX_CHANNELS = 32
MAX_REACH = 200  # delay + filter_len
RANGE = (f"1 <= n_channels * filter_len <= {MAX_TAPS}, n_channels <= {MAX_CHANNELS}, delay >= 1 and "
         f"delay + filter_len <= {MAX_REACH}")


class _WpeParams(ctypes.Structure):
    """Mirror of ``WpeParams`` in csrc/wpe.cu."""

    _fields_ = [(name, ctypes.c_float) for name in ("lam", "inv_lam", "alpha", "one_m_alpha", "p_init", "inv_c")]


def _params(cfg) -> _WpeParams:
    lam = float(cfg.forgetting_factor)
    return _WpeParams(lam=lam, inv_lam=1.0 / lam, alpha=cfg.alpha_var, one_m_alpha=1.0 - cfg.alpha_var,
                      p_init=cfg.p_init, inv_c=1.0 / cfg.n_channels)


def _launch(cfg, D, e, stream) -> int:
    """``wpe_frames``' launch on D [T, NB, F, C] (any strides) into e; its error code."""
    T, NB, F, C = D.shape
    params = _params(cfg)
    return _build.load("wpe").wpe_launch(D.data_ptr(), *D.stride(), e.data_ptr(), T, NB, F, C, cfg.filter_len,
                                         cfg.delay, ctypes.addressof(params), stream)


def check_input(cfg, D_tf: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernel takes ``cfg`` and D_tf
    (complex64 [T, ..., F, C], T >= 1): its shape, dtype and the range."""
    C, N, delay = cfg.n_channels, cfg.filter_len, cfg.delay
    if not (1 <= C * N <= MAX_TAPS and C <= MAX_CHANNELS and delay >= 1 and delay + N <= MAX_REACH and N >= 1):
        raise ValueError(f"wpe_run: the kernel takes {RANGE}; got n_channels={C}, filter_len={N}, delay={delay}")
    if D_tf.dtype != torch.complex64:
        raise ValueError(f"wpe_run: the kernel runs in complex64 (float32), got {D_tf.dtype}")
    if D_tf.ndim < 3 or D_tf.shape[0] < 1 or D_tf.shape[-1] != C or D_tf.shape[-2] != cfg.half_bin:
        raise ValueError(f"wpe_run: the spectra must be [T >= 1, ..., F = {cfg.half_bin}, C = {C}], "
                         f"got {tuple(D_tf.shape)}")


def wpe_frames(cfg, D_tf: torch.Tensor) -> torch.Tensor:
    """The kernel: D_tf [T, ..., F, C] complex64 on a card (any strides) ->
    e [T, ..., F, C], contiguous, on D_tf's card.  One launch."""
    check_input(cfg, D_tf)
    if D_tf.device.type != "cuda":
        raise ValueError(f"wpe_run: the kernel takes CUDA tensors, got one on {D_tf.device}")
    T, F, C = D_tf.shape[0], D_tf.shape[-2], D_tf.shape[-1]
    D = D_tf.reshape(T, -1, F, C)  # a view of wpe_analysis's layout
    with torch.cuda.device(D.device):
        e = torch.empty(D.shape, dtype=D.dtype, device=D.device)
        err = _launch(cfg, D, e, torch.cuda.current_stream(D.device).cuda_stream)
    _build.check_launch("wpe", err, "wpe_run")
    count("launch.wpe_run")
    return e.view(D_tf.shape)
