"""Canonical-space NeRF MLP — counterpart of ``animnerf_tpu/models/nerf.py::NeRFMLP``.

The flagship field only (``use_view=False``, no latent codes): D=8, W=256,
skip at layer 4, sigma head, xyz_final, dir_0 (W/2), rgb. Parameters keep
the flax names (``xyz_0..7``, ``sigma``, ``xyz_final``, ``dir_0``,
``rgb``) as ``nn.Linear`` submodules, whose (out, in) weights are the flax
(in, out) kernels transposed (``utils/convert.py``), initialised as flax's
``Dense`` is: truncated-normal fan-in kernels (``lecun_normal``), zero
biases.

``forward`` / ``forward_rows`` run the fused encode+MLP: the CUDA kernels
on the card, their plain versions on the CPU (``ops/fused_mlp.py``). Under
``no_grad`` they read packed operands cached in the compute dtype, repacked
whenever a parameter changed (an optimizer step, a load) or the module
moved. With autograd on they pack from the live parameters inside
autograd, so the packed gradients flow back through the packing's pads
and slices to the ``nn.Linear`` weights. ``get_sigma`` is the plain
trunk + sigma head of ``nn.Linear`` layers, differentiable twice (the
normal loss differentiates its input gradient).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from animnerf_tpu_torch.models.embedding import (
    embedding_dim,
    positional_encoding,
)
from animnerf_tpu_torch.ops.fused_mlp import (
    DEPTH,
    DIR_W,
    DTYPES,
    SKIP,
    WIDTH,
    fused_nerf_rows,
    pack_params,
)

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """flax ``lecun_normal`` on an ``nn.Linear`` (out, in) weight: a normal
    truncated to +-2 std with variance 1 / fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std,
                                 generator=generator)


class NeRFMLP(nn.Module):
    """xyz (B, N, 3) -> (rgb (B, N, 3), sigma (B, N, 1)), float32 out."""

    def __init__(self, freqs_xyz: int = 10, compute_dtype: str = "float32",
                 generator=None):
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
        for m in self.children():
            lecun_normal_(m.weight, generator)
            nn.init.zeros_(m.bias)
        self._packed = None

    def _versions(self):
        return tuple(p._version for p in self.parameters())

    def packed(self):
        """(ws, bs) for the fused forward (see ops/fused_mlp.pack_params),
        packed again whenever a parameter changed since the last pack."""
        vers = self._versions()
        if self._packed is None or self._packed[0] != vers:
            self._packed = (vers, pack_params(
                {k: v.detach() for k, v in self.state_dict().items()},
                self.freqs_xyz, self.compute_dtype))
        return self._packed[1]

    def load_state_dict(self, *args, **kwargs):
        self._packed = None
        return super().load_state_dict(*args, **kwargs)

    def _apply(self, fn, *args, **kwargs):
        self._packed = None
        return super()._apply(fn, *args, **kwargs)

    def forward_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """rows (B, 8, N) [x|y|z|..] -> (B, 8, N) [r|g|b|sigma|0..]."""
        if torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()):
            # float32 packing inside autograd; the Function casts to the
            # compute dtype, so the weight gradients stay float32
            ws, bs = pack_params(dict(self.named_parameters()),
                                 self.freqs_xyz, "float32")
        else:
            ws, bs = self.packed()
        return fused_nerf_rows(rows, ws, bs, self.freqs_xyz,
                               self.compute_dtype)

    def forward(self, xyz: torch.Tensor):
        rows = torch.nn.functional.pad(xyz.transpose(1, 2), (0, 0, 0, 5))
        out = self.forward_rows(rows)
        return out[:, 0:3].transpose(1, 2), out[:, 3:4].transpose(1, 2)

    def get_sigma(self, xyz: torch.Tensor) -> torch.Tensor:
        """(..., 3) -> (..., 1) density through the plain trunk and sigma
        head, twice differentiable. In bfloat16 it rounds where flax's
        ``Dense(dtype=bfloat16)`` does: each trunk layer's operands and
        output, and its bias add; the sigma head runs in float32."""
        dt = DTYPES[self.compute_dtype]
        enc = positional_encoding(xyz, self.freqs_xyz).to(dt)
        h = enc
        for i in range(DEPTH):
            if i == SKIP:
                h = torch.cat([enc, h], dim=-1)
            layer = getattr(self, f"xyz_{i}")
            y = torch.nn.functional.linear(h, layer.weight.to(dt))
            h = torch.relu(y + layer.bias.to(dt))
        return self.sigma(h.to(torch.float32))
