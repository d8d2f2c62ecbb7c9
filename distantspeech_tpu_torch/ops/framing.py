"""Framing and overlap-add (counterpart of ``distantspeech_tpu/ops/framing.py``).

When ``frame_len`` is a multiple of ``hop`` (every STFT config here), both
are reshapes of hop-sized blocks plus R = frame_len // hop shifted adds, so
no gather or scatter index tensor is built.
"""

from __future__ import annotations

import torch


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """[..., samples] -> [..., n_frames, frame_len], n_frames = 1 +
    (samples - frame_len) // hop (tail truncated)."""
    samples = x.shape[-1]
    n_frames = 1 + (samples - frame_len) // hop
    if frame_len % hop == 0:
        r = frame_len // hop
        blocks = x[..., : (n_frames + r - 1) * hop].reshape(*x.shape[:-1], n_frames + r - 1, hop)
        return torch.cat([blocks[..., j : j + n_frames, :] for j in range(r)], dim=-1)
    idx = torch.arange(n_frames, device=x.device)[:, None] * hop + torch.arange(frame_len, device=x.device)[None, :]
    return x[..., idx]


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[..., n_frames, frame_len] -> [..., frame_len + hop * (n_frames - 1)]."""
    *batch, n_frames, frame_len = frames.shape
    out_len = frame_len + hop * (n_frames - 1)
    y = frames.new_zeros((*batch, out_len))
    if frame_len % hop == 0:
        r = frame_len // hop
        lanes = frames.reshape(*batch, n_frames, r, hop)
        for j in range(r):
            y[..., j * hop : j * hop + n_frames * hop] += lanes[..., :, j, :].reshape(*batch, n_frames * hop)
        return y
    idx = torch.arange(n_frames, device=frames.device)[:, None] * hop + torch.arange(frame_len, device=frames.device)
    y.index_add_(-1, idx.reshape(-1), frames.reshape(*batch, -1))
    return y
