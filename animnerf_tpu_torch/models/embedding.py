"""Sinusoidal positional encoding — counterpart of
``animnerf_tpu/models/embedding.py``. Layout (needed for checkpoint
parity): [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...], each
applied to the full channel block."""

from __future__ import annotations

import torch


def embedding_dim(in_channels: int, n_freqs: int) -> int:
    return in_channels * (2 * n_freqs + 1)


def positional_encoding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """(..., C) -> (..., C * (2 * n_freqs + 1)), log-scale frequencies."""
    if n_freqs == 0:
        return x
    parts = [x]
    for j in range(n_freqs):
        a = float(2.0 ** j) * x
        parts += [torch.sin(a), torch.cos(a)]
    return torch.cat(parts, dim=-1)
