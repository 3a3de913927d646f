"""Device resolution for the port's entry points.

Counterpart of ``animnerf_tpu/utils/platform.py``. Entry points run on
CUDA unless the caller asks for the CPU explicitly; with no GPU and no
explicit ``"cpu"`` they raise instead of carrying on silently on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> the current CUDA device (raises without one); "cpu" -> CPU;
    any other CUDA spec is checked for availability."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def pin_fp32_geometry() -> None:
    """Full-precision float32 products for the geometry (the JAX package
    pins Precision.HIGHEST, models/warp.py:68,77): TF32 keeps ~3 decimal
    digits, which would move kNN ranks and the LBS blend."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
