"""Block delay lines as explicit ``(carry, x) -> (carry, y)`` steps.

Counterpart of ``distantspeech_tpu/ops/delay.py``:

- ``delay_samples``: an exact D-sample delay applied blockwise, for any
  relation between block length and delay;
- ``delay_frames``: a FIFO of frames that returns the frame pushed
  ``n_slots`` calls ago (the reference's ``DelayFrames(len, d)`` delays by
  d + 1 frames, so its carry has ``n_slots = d + 1``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from distantspeech_tpu_torch._device import resolve_device


def delay_samples_init(batch_shape, delay: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Carry for ``delay_samples``: the last ``delay`` samples, zeros at start."""
    return torch.zeros((*batch_shape, delay), dtype=dtype, device=resolve_device(device))


def delay_samples(carry: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Delay a block by ``carry.shape[-1]`` samples.
    carry: [..., D]; x: [..., L] -> (new_carry [..., D], y [..., L])."""
    if carry.shape[-1] == 0:
        return carry, x
    L = x.shape[-1]
    buf = torch.cat([carry, x], dim=-1)
    return buf[..., L:], buf[..., :L]


def delay_frames_init(batch_shape, n_slots: int, frame_shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """Carry for ``delay_frames``: ``n_slots`` queued frames, zeros at start."""
    return torch.zeros((*batch_shape, n_slots, *frame_shape), dtype=dtype, device=resolve_device(device))


def delay_frames(carry: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """FIFO of frames.  carry: [..., S, frame]; x: [..., frame]."""
    return torch.cat([carry[..., 1:, :], x[..., None, :]], dim=-2), carry[..., 0, :]
