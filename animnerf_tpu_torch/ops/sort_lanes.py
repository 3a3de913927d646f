"""Per-row lane permutation / gather of channel-leading payloads: CUDA
kernel plus plain version.

Counterpart of ``animnerf_tpu/ops/sort_lanes.py``: ``permute_lanes`` (the
fine pass's per-ray depth merge-sort over K <= 128 samples) and
``gather_lanes`` (sample_fine's CDF-bound lookups), both reaching the TPU
kernel ``_permute_kernel`` through ``_permute_lanes_pallas``. Forward only:
the inverse-permutation backward belongs to the training slice.
"""

from __future__ import annotations

import torch

from animnerf_tpu_torch.ops import _build

LANES = 128


def _gather(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    B, C, R, L = payload.shape
    J = idx.shape[-1]
    if idx.shape != (B, R, J) or L > LANES or J > LANES:
        raise ValueError(f"payload (B, C, R, L<=128) and idx (B, R, J<=128)"
                         f" expected, got {tuple(payload.shape)} and "
                         f"{tuple(idx.shape)}")
    if payload.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError("lane gather takes a float32 payload, int32 idx")
    if payload.device.type == "cpu":
        return gather_lanes_plain(payload, idx)
    payload, idx = payload.contiguous(), idx.contiguous()
    _build.check_cuda("gather_lanes", payload, idx)
    out = torch.empty((B, C, R, J), dtype=torch.float32,
                      device=payload.device)
    if out.numel() == 0:
        return out
    _build.kernel_library().call(
        "animnerf_gather_lanes", payload.data_ptr(), idx.data_ptr(),
        out.data_ptr(), B, C, R, L, J, _build.stream_of(payload))
    _build.LAUNCHES["permute_lanes"] += 1
    return out


def gather_lanes_plain(payload: torch.Tensor, idx: torch.Tensor):
    """out[b, c, r, j] = payload[b, c, r, idx[b, r, j]] (torch.gather)."""
    B, C, R, _ = payload.shape
    J = idx.shape[-1]
    return torch.gather(payload, 3,
                        idx.long()[:, None].expand(B, C, R, J))


def gather_lanes(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """payload (B, C, R, L <= 128), idx (B, R, J <= 128) with values in
    [0, L) -> (B, C, R, J); idx need not be a permutation."""
    return _gather(payload, idx)


def permute_lanes(payload: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """payload (B, C, R, 128) re-ordered along the last axis by the
    permutation ``order`` (B, R, 128)."""
    if payload.shape[-1] != LANES or order.shape[-1] != LANES:
        raise ValueError("permute_lanes works on 128 lanes")
    return _gather(payload, order)
