"""Pre/de-emphasis and the speex-style DC notch.

Counterpart of ``distantspeech_tpu/adaptive/feature.py``.  Pre-emphasis is
a shift (no recurrence); de-emphasis is a first-order IIR and the DC notch
a 2-state constant-coefficient affine recurrence, both evaluated by the
blocked state-space form of ``ops.iir``.  Every function takes and returns
an explicit carry, so chunked processing matches one whole-signal call.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from distantspeech_tpu_torch._device import resolve_device
from distantspeech_tpu_torch.ops.iir import constant_affine_blocked, first_order_recurrence


class EmphasisState(NamedTuple):
    memD: torch.Tensor  # last input sample   [...]
    memE: torch.Tensor  # last output sample  [...]


def emphasis_init(batch_shape=(), dtype=torch.float32, device=None) -> EmphasisState:
    z = torch.zeros(batch_shape, dtype=dtype, device=resolve_device(device))
    return EmphasisState(memD=z, memE=z)


def pre_emphasis(state: EmphasisState, x: torch.Tensor, alpha: float = 0.98) -> Tuple[EmphasisState, torch.Tensor]:
    """y[n] = x[n] - alpha x[n-1].  x: [..., N]."""
    prev = torch.cat([state.memD[..., None], x[..., :-1]], dim=-1)
    return state._replace(memD=x[..., -1]), x - alpha * prev


def de_emphasis(state: EmphasisState, x: torch.Tensor, alpha: float = 0.98) -> Tuple[EmphasisState, torch.Tensor]:
    """y[n] = x[n] + alpha y[n-1].  x: [..., N]."""
    y = first_order_recurrence(alpha, x, state.memE)
    return state._replace(memE=y[..., -1]), y


class DcNotchState(NamedTuple):
    mem: torch.Tensor  # [..., 2]


def dc_notch_init(batch_shape=(), dtype=torch.float32, device=None) -> DcNotchState:
    return DcNotchState(mem=torch.zeros((*batch_shape, 2), dtype=dtype, device=resolve_device(device)))


def dc_notch(state: DcNotchState, x: torch.Tensor, radius: float = 0.9) -> Tuple[DcNotchState, torch.Tensor]:
    """Speex DC-notch biquad.  Per sample (vin = x[n], vout = mem0 + vin):

        out[n] = radius * vout
        mem0'  = mem1 + 2 (-vin + radius vout)
        mem1'  = vin - den2 vout,   den2 = radius^2 + 0.7 (1-radius)^2

    i.e. mem' = A mem + Bv vin with constant A.  x: [..., N] ->
    (new_state, out [..., N])."""
    r = radius
    den2 = r * r + 0.7 * (1.0 - r) * (1.0 - r)
    A = np.array([[2.0 * r, 1.0], [-den2, 0.0]])
    Bv = np.array([2.0 * r - 2.0, 1.0 - den2])
    mem_seq = constant_affine_blocked(A, Bv, x, state.mem)  # [..., N, 2], post-sample states
    mem0_prev = torch.cat([state.mem[..., :1], mem_seq[..., :-1, 0]], dim=-1)  # vout[n] = mem0[n-1] + x[n]
    return DcNotchState(mem=mem_seq[..., -1, :]), r * (mem0_prev + x)
