"""Canonical-space NeRF MLP — counterpart of ``animnerf_tpu/models/nerf.py::NeRFMLP``.

The flagship field only (``use_view=False``, no latent codes): D=8, W=256,
skip at layer 4, sigma head, xyz_final, dir_0 (W/2), rgb. Parameters keep
the flax names (``xyz_0..7``, ``sigma``, ``xyz_final``, ``dir_0``,
``rgb``) as ``nn.Linear`` submodules, whose (out, in) weights are the flax
(in, out) kernels transposed (``utils/convert.py``). The forward runs the
fused encode+MLP: the CUDA kernel on the card, its plain version on the
CPU (``ops/fused_mlp.py``). The packed operands are built once and
cached; loading weights or moving the module drops the cache.
"""

from __future__ import annotations

import torch
from torch import nn

from animnerf_tpu_torch.models.embedding import embedding_dim
from animnerf_tpu_torch.ops.fused_mlp import (
    DEPTH,
    DIR_W,
    SKIP,
    WIDTH,
    fused_nerf_rows,
    pack_params,
)


class NeRFMLP(nn.Module):
    """xyz (B, N, 3) -> (rgb (B, N, 3), sigma (B, N, 1)), float32 out."""

    def __init__(self, freqs_xyz: int = 10, compute_dtype: str = "float32"):
        super().__init__()
        self.freqs_xyz = freqs_xyz
        self.compute_dtype = compute_dtype
        enc = embedding_dim(3, freqs_xyz)
        for i in range(DEPTH):
            d_in = enc if i == 0 else WIDTH + (enc if i == SKIP else 0)
            setattr(self, f"xyz_{i}", nn.Linear(d_in, WIDTH))
        self.sigma = nn.Linear(WIDTH, 1)
        self.xyz_final = nn.Linear(WIDTH, WIDTH)
        self.dir_0 = nn.Linear(WIDTH, DIR_W)
        self.rgb = nn.Linear(DIR_W, 3)
        self._packed = None

    def packed(self):
        """(ws, bs) for the fused forward (see ops/fused_mlp.pack_params),
        packed at the first call after a load or a move."""
        if self._packed is None:
            self._packed = pack_params(
                {k: v.detach() for k, v in self.state_dict().items()},
                self.freqs_xyz, self.compute_dtype)
        return self._packed

    def load_state_dict(self, *args, **kwargs):
        self._packed = None
        return super().load_state_dict(*args, **kwargs)

    def _apply(self, fn, *args, **kwargs):
        self._packed = None
        return super()._apply(fn, *args, **kwargs)

    def forward(self, xyz: torch.Tensor):
        rows = torch.nn.functional.pad(xyz.transpose(1, 2), (0, 0, 0, 5))
        ws, bs = self.packed()
        out = fused_nerf_rows(rows, ws, bs, self.freqs_xyz,
                              self.compute_dtype)
        return out[:, 0:3].transpose(1, 2), out[:, 3:4].transpose(1, 2)
