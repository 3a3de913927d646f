"""Canonical-space NeRF and deformation (DeRF) MLPs — counterpart of
``animnerf_tpu/models/nerf.py`` (``NeRFMLP``, ``DeRFMLP``,
``rotation_from_ortho6d``).

``NeRFMLP``: D=8, W=256, skip at layer 4, sigma head, xyz_final, dir_0
(W/2), rgb; with ``use_view`` the view direction's encoding
(``freqs_dir``) and with ``apperance_dim`` the appearance code join
xyz_final's output into dir_0, and with ``deformation_dim`` the
deformation code joins the xyz encoding into the trunk (``nerf.py:52-82``
there). Parameters keep the flax names (``xyz_0..7``, ``sigma``,
``xyz_final``, ``dir_0``, ``rgb``) as ``nn.Linear`` submodules, whose
(out, in) weights are the flax (in, out) kernels transposed
(``utils/convert.py``), initialised as flax's ``Dense`` is:
truncated-normal fan-in kernels (``lecun_normal``), zero biases.

A field of the flagship architecture (``fused``: no view, no codes)
runs the fused encode+MLP: the CUDA kernels on the card, their plain
versions on the CPU (``ops/fused_mlp.py``). Under ``no_grad`` it reads
packed operands cached in the compute dtype (on the card also the
kernels' weight image, ``kernel_image``), repacked whenever a parameter
changed (an optimizer step, a load) or the module moved. With autograd
on it packs from the live parameters inside autograd, so the packed
gradients flow back through the packing's pads and slices to the
``nn.Linear`` weights. Any other field is the plain MLP of ``nn.Linear``
layers (``forward_plain``), as the JAX package runs it in XLA: layers in
the compute dtype, heads in float32, as flax's ``Dense(dtype=...)``
rounds; ``remat`` recomputes it in the backward
(``torch.utils.checkpoint``, JAX's ``jax.checkpoint``). ``get_sigma`` is
the plain trunk + sigma head, differentiable twice (the normal loss
differentiates its input gradient).
"""

from __future__ import annotations

import math
from typing import Optional

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
    kernel_image,
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


def _init_flax(module: nn.Module, generator) -> None:
    for m in module.children():
        lecun_normal_(m.weight, generator)
        nn.init.zeros_(m.bias)


def dense(layer: nn.Linear, h: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dt)``: operands, product and bias add in dt."""
    y = torch.nn.functional.linear(h.to(dt), layer.weight.to(dt))
    return y + layer.bias.to(dt)


class NeRFMLP(nn.Module):
    """xyz (B, N, 3) [+ viewdir, codes] -> (rgb (B, N, 3), sigma
    (B, N, 1)), float32 out."""

    def __init__(self, freqs_xyz: int = 10, compute_dtype: str = "float32",
                 generator=None, freqs_dir: int = 4, use_view: bool = False,
                 deformation_dim: int = 0, apperance_dim: int = 0,
                 fused: Optional[bool] = None, remat: bool = False):
        """fused: the kernel path; None takes it exactly when the field has
        the flagship architecture (the only one the kernel computes)."""
        super().__init__()
        self.freqs_xyz = freqs_xyz
        self.freqs_dir = freqs_dir
        self.use_view = use_view
        self.deformation_dim = deformation_dim
        self.apperance_dim = apperance_dim
        self.compute_dtype = compute_dtype
        self.remat = remat
        flagship = not use_view and deformation_dim == 0 \
            and apperance_dim == 0
        if fused is None:
            fused = flagship
        if fused and not flagship:
            raise ValueError("the fused MLP computes the flagship field "
                             "only (no view, no latent codes)")
        self.fused = fused
        enc = embedding_dim(3, freqs_xyz) + deformation_dim
        for i in range(DEPTH):
            d_in = enc if i == 0 else WIDTH + (enc if i == SKIP else 0)
            setattr(self, f"xyz_{i}", nn.Linear(d_in, WIDTH))
        self.sigma = nn.Linear(WIDTH, 1)
        self.xyz_final = nn.Linear(WIDTH, WIDTH)
        dir_in = WIDTH + (embedding_dim(3, freqs_dir) if use_view else 0) \
            + apperance_dim
        self.dir_0 = nn.Linear(dir_in, DIR_W)
        self.rgb = nn.Linear(DIR_W, 3)
        _init_flax(self, generator)
        self._packed = None
    def _versions(self):
        return tuple(p._version for p in self.parameters())

    def packed(self):
        """(ws, bs) for the fused forward (see ops/fused_mlp.pack_params),
        packed again whenever a parameter changed since the last pack."""
        vers = self._versions()
        if self._packed is None or self._packed[0] != vers:
            self._packed = [vers, pack_params(
                {k: v.detach() for k, v in self.state_dict().items()},
                self.freqs_xyz, self.compute_dtype), None]
        return self._packed[1]

    def packed_image(self):
        """``kernel_image`` of ``packed()``'s weights (the kernels' weight
        image in the compute dtype and its offsets), built once per
        pack."""
        ws, _ = self.packed()
        if self._packed[2] is None:
            self._packed[2] = kernel_image(ws)
        return self._packed[2]

    def load_state_dict(self, *args, **kwargs):
        self._packed = None
        return super().load_state_dict(*args, **kwargs)

    def _apply(self, fn, *args, **kwargs):
        self._packed = None
        return super()._apply(fn, *args, **kwargs)

    def forward_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """rows (B, 8, N) [x|y|z|..] -> (B, 8, N) [r|g|b|sigma|0..]."""
        if not self.fused:
            raise ValueError("forward_rows is the fused MLP: this field "
                             "takes the plain MLP (forward_plain)")
        if torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()):
            # float32 packing inside autograd; the Function casts to the
            # compute dtype, so the weight gradients stay float32
            ws, bs = pack_params(dict(self.named_parameters()),
                                 self.freqs_xyz, "float32")
            image = None
        else:
            ws, bs = self.packed()
            image = (self.packed_image() if ws[0].device.type != "cpu"
                     else None)
        return fused_nerf_rows(rows, ws, bs, self.freqs_xyz,
                               self.compute_dtype, image)

    def forward(self, xyz: torch.Tensor, viewdir=None,
                deformation_code=None, apperance_code=None):
        """(rgb, sigma) of (B, N, 3) points; the codes are (B, N, dim)."""
        if not self.fused:
            args = (xyz, viewdir, deformation_code, apperance_code)
            if self.remat and torch.is_grad_enabled():
                return torch.utils.checkpoint.checkpoint(
                    self.forward_plain, *args, use_reentrant=False)
            return self.forward_plain(*args)
        rows = torch.nn.functional.pad(xyz.transpose(1, 2), (0, 0, 0, 5))
        out = self.forward_rows(rows)
        return out[:, 0:3].transpose(1, 2), out[:, 3:4].transpose(1, 2)

    def _trunk(self, xyz: torch.Tensor, deformation_code=None):
        """The shared xyz trunk -> (sigma (..., 1) float32, features)."""
        dt = DTYPES[self.compute_dtype]
        h = positional_encoding(xyz, self.freqs_xyz)
        if self.deformation_dim > 0:
            h = torch.cat([h, deformation_code.to(h.dtype)], dim=-1)
        enc = h.to(dt)
        h = enc
        for i in range(DEPTH):
            if i == SKIP:
                h = torch.cat([enc, h], dim=-1)
            h = torch.relu(dense(getattr(self, f"xyz_{i}"), h, dt))
        return self.sigma(h.to(torch.float32)), h

    def forward_plain(self, xyz: torch.Tensor, viewdir=None,
                      deformation_code=None, apperance_code=None):
        """The plain MLP (``animnerf_tpu/models/nerf.py::NeRFMLP.__call__``):
        trunk, xyz_final, [view encoding | appearance code], dir_0 + ReLU,
        rgb + sigmoid in float32."""
        dt = DTYPES[self.compute_dtype]
        sigma, h = self._trunk(xyz, deformation_code)
        d_in = dense(self.xyz_final, h, dt)
        if self.use_view:
            d_in = torch.cat([d_in, positional_encoding(
                viewdir, self.freqs_dir).to(dt)], dim=-1)
        if self.apperance_dim > 0:
            d_in = torch.cat([d_in, apperance_code.to(dt)], dim=-1)
        d = torch.relu(dense(self.dir_0, d_in, dt))
        rgb = torch.sigmoid(self.rgb(d.to(torch.float32)))
        return rgb, sigma

    def get_sigma(self, xyz: torch.Tensor,
                  deformation_code=None) -> torch.Tensor:
        """(..., 3) -> (..., 1) density through the plain trunk and sigma
        head, twice differentiable. In bfloat16 it rounds where flax's
        ``Dense(dtype=bfloat16)`` does: each trunk layer's operands and
        output, and its bias add; the sigma head runs in float32."""
        return self._trunk(xyz, deformation_code)[0]


class DeRFMLP(nn.Module):
    """Deformation field (reference models/nerf.py:7-58): xyz (+ code)
    -> 9 outputs (ortho-6d rotation + translation); D=6, W=128, skip at
    layer 4, layers in the compute dtype, the output head in float32.
    Names as flax's (``xyz_0..5``, ``out``)."""

    depth = 6
    width = 128
    skip = 4

    def __init__(self, freqs_xyz: int = 10, deformation_dim: int = 0,
                 compute_dtype: str = "float32", generator=None,
                 out_channels: int = 9):
        super().__init__()
        self.freqs_xyz = freqs_xyz
        self.deformation_dim = deformation_dim
        self.compute_dtype = compute_dtype
        enc = embedding_dim(3, freqs_xyz) + deformation_dim
        for i in range(self.depth):
            d_in = enc if i == 0 else self.width + (
                enc if i == self.skip else 0)
            setattr(self, f"xyz_{i}", nn.Linear(d_in, self.width))
        self.out = nn.Linear(self.width, out_channels)
        _init_flax(self, generator)

    def forward(self, xyz: torch.Tensor, deformation_code=None):
        dt = DTYPES[self.compute_dtype]
        h = positional_encoding(xyz, self.freqs_xyz)
        if self.deformation_dim > 0:
            h = torch.cat([h, deformation_code.to(h.dtype)], dim=-1)
        enc = h.to(dt)
        h = enc
        for i in range(self.depth):
            if i == self.skip:
                h = torch.cat([enc, h], dim=-1)
            h = torch.relu(dense(getattr(self, f"xyz_{i}"), h, dt))
        return self.out(h.to(torch.float32))


def rotation_from_ortho6d(ortho6d: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt two-vector rotation (Zhou et al. 2019; reference
    models/anim_nerf.py:9-22): (..., 6) -> (..., 3, 3) with columns
    x, y, z."""
    x_raw = ortho6d[..., 0:3]
    y_raw = ortho6d[..., 3:6]
    x = x_raw / (torch.linalg.norm(x_raw, dim=-1, keepdim=True) + 1e-8)
    z = torch.linalg.cross(x, y_raw, dim=-1)
    z = z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-8)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)
