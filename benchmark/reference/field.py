"""The canonical NeRF MLP of Anim-NeRF in plain float32 PyTorch.

Layers as published (Mildenhall et al. 2020, Anim-NeRF's ``NeRF``):
``netdepth`` ReLU layers of ``netwidth`` on the positional encoding
[x, sin(2^0 x), cos(2^0 x), ...], the encoding joined again before layer
``skips``, a sigma head on the trunk, a linear ``xyz_final``, ``dir_0``
(half the width) with a ReLU and a sigmoid rgb head. Parameters are a
dict {layer: (weight (out, in), bias)}.

``quant="fp8"`` is the control, the field trained in float8 as a
Transformer-Engine-style recipe does: every layer's forward operands
rounded to e4m3 and the gradient arriving at its output to e5m2, each
with one scale a tensor (its largest magnitude to the format's largest
value); the products accumulate in float32, and the rounding passes the
gradient straight through, so the normal term's double backward runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    parts = [x]
    for j in range(n_freqs):
        a = float(2.0 ** j) * x
        parts += [torch.sin(a), torch.cos(a)]
    return torch.cat(parts, dim=-1)


def fp8(x: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to ``fmt`` at a per-tensor scale; gradient straight
    through."""
    scale = FP8[fmt] / x.detach().abs().amax().clamp_min(1e-30)
    q = (x.detach() * scale).to(fmt).to(torch.float32) / scale
    return x + (q - x.detach())


class _GradFP8(torch.autograd.Function):
    """The identity; its backward rounds the incoming gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return fp8(g, torch.float8_e5m2)


def linear(p: dict, name: str, h: torch.Tensor, quant=None) -> torch.Tensor:
    w, b = p[name]
    if quant == "fp8":
        return _GradFP8.apply(F.linear(fp8(h), fp8(w), b))
    return F.linear(h, w, b)


def trunk(p: dict, x: torch.Tensor, arch: dict, quant=None):
    """(N, 3) canonical points -> (sigma (N, 1), trunk features)."""
    enc = encode(x, arch["freqs_xyz"])
    h = enc
    for i in range(arch["netdepth"]):
        if i in arch["skips"]:
            h = torch.cat([enc, h], dim=-1)
        h = torch.relu(linear(p, f"xyz_{i}", h, quant))
    return linear(p, "sigma", h, quant), h


def mlp(p: dict, x: torch.Tensor, arch: dict, quant=None):
    """(N, 3) -> (rgb (N, 3), sigma (N,))."""
    sigma, h = trunk(p, x, arch, quant)
    f = linear(p, "xyz_final", h, quant)
    d = torch.relu(linear(p, "dir_0", f, quant))
    return torch.sigmoid(linear(p, "rgb", d, quant)), sigma[..., 0]


def layer_shapes(arch: dict) -> dict:
    """{layer: (out, in)} of the field from the published widths."""
    W, D = arch["netwidth"], arch["netdepth"]
    enc = 3 * (2 * arch["freqs_xyz"] + 1)
    shapes = {}
    for i in range(D):
        d_in = enc if i == 0 else W + (enc if i in arch["skips"] else 0)
        shapes[f"xyz_{i}"] = (W, d_in)
    shapes["sigma"] = (1, W)
    shapes["xyz_final"] = (W, W)
    shapes["dir_0"] = (W // 2, W)
    shapes["rgb"] = (3, W // 2)
    return shapes


def flops_per_sample(arch: dict) -> float:
    """Multiply-adds of one point through the field, times 2."""
    return 2.0 * sum(o * i for o, i in layer_shapes(arch).values())
