"""Fused positional-encoding + canonical NeRF MLP forward: CUDA kernel
plus plain version.

Counterpart of ``animnerf_tpu/ops/fused_mlp.py`` (``pack_params`` and
``fused_nerf_fwd`` / ``fused_nerf_rows``), forward only: xyz rows
(1, 8, M) [x|y|z|..] -> (1, 8, M) rows [r|g|b|sigma|0 0 0 0] f32.

Architecture (the flagship field, ``use_view=False``, no codes): 8x256
ReLU trunk with the skip at layer 4 as a split product, sigma head,
xyz_final (no ReLU), dir_0 (128) + ReLU, rgb (3) + sigmoid. In bfloat16
the rounding points are those of the TPU kernel (ops/fused_mlp.py:160-179
there): encoding cast to bf16, each trunk layer relu(bf16(bf16(acc) +
bf16(b))), sigma and rgb from f32 accumulators and f32 biases, hf and hd
rounded like a trunk layer (hf without ReLU). In float32 nothing is
rounded.
"""

from __future__ import annotations

import ctypes

import torch

from animnerf_tpu_torch.models.embedding import positional_encoding
from animnerf_tpu_torch.ops import _build

WIDTH = 256
DEPTH = 8
SKIP = 4
DIR_W = 128
N_W = DEPTH + 5  # trunk 0..7, skip-enc half, sigma, xyz_final, dir_0, rgb
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def enc_rows(n_freqs: int) -> int:
    """Padded row count of the encoding block (as the JAX package)."""
    return max(8, -(-(3 + 6 * n_freqs) // 8) * 8)


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, str):
        if dtype not in DTYPES:
            raise ValueError(f"compute dtype {dtype!r} not in {list(DTYPES)}")
        return DTYPES[dtype]
    if dtype not in DTYPES.values():
        raise ValueError(f"compute dtype {dtype} not bfloat16/float32")
    return dtype


def pack_params(state: dict, n_freqs: int, dtype="bfloat16"):
    """NeRFMLP state dict (``xyz_0.weight`` ... as ``nn.Linear`` stores
    them, (out, in)) -> (ws, bs) exactly as the JAX ``pack_params``:
      ws[0]     (256, E)    xyz_0 (E = enc_rows(n_freqs), zero-padded)
      ws[1..7]  (256, 256)  xyz_1..7; ws[4] is the h-half of the skip layer
      ws[8]     (256, E)    enc-half of xyz_4
      ws[9]     (8, 256)    sigma (rows zero-padded from 1)
      ws[10]    (256, 256)  xyz_final
      ws[11]    (128, 256)  dir_0
      ws[12]    (8, 128)    rgb (rows zero-padded from 3)
    in the compute dtype, and biases (R, 1) float32 (bs[8] zeros)."""
    dt = _dtype(dtype)
    enc_dim = 3 + 6 * n_freqs
    E = enc_rows(n_freqs)

    def W(name):
        return state[f"{name}.weight"]

    def pad(w, rows=None, cols=None):
        r = (rows or w.shape[0]) - w.shape[0]
        c = (cols or w.shape[1]) - w.shape[1]
        return torch.nn.functional.pad(w, (0, c, 0, r)).to(dt).contiguous()

    def pad_b(b, rows=None):
        r = (rows or b.shape[0]) - b.shape[0]
        return torch.nn.functional.pad(b, (0, r)).reshape(-1, 1).to(
            torch.float32).contiguous()

    ws = [pad(W("xyz_0"), cols=E)]
    for i in range(1, DEPTH):
        w = W(f"xyz_{i}")
        ws.append(pad(w[:, enc_dim:] if i == SKIP else w))
    ws.append(pad(W(f"xyz_{SKIP}")[:, :enc_dim], cols=E))
    ws.append(pad(W("sigma"), rows=8))
    ws.append(pad(W("xyz_final")))
    ws.append(pad(W("dir_0")))
    ws.append(pad(W("rgb"), rows=8))

    bs = [pad_b(state[f"xyz_{i}.bias"]) for i in range(DEPTH)]
    bs.append(pad_b(torch.zeros(WIDTH, device=ws[0].device)))
    bs.append(pad_b(state["sigma.bias"], rows=8))
    bs.append(pad_b(state["xyz_final.bias"]))
    bs.append(pad_b(state["dir_0.bias"]))
    bs.append(pad_b(state["rgb.bias"], rows=8))
    return tuple(ws), tuple(bs)


def encode_rows(xyz: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """(3, M) coordinates -> (E, M) f32 encoding rows (the layout of
    models/embedding.py), zero-padded to enc_rows(n_freqs)."""
    enc = positional_encoding(xyz.t(), n_freqs).t()
    pad = enc_rows(n_freqs) - enc.shape[0]
    return torch.nn.functional.pad(enc, (0, 0, 0, pad))


def fused_nerf_fwd_plain(xyz_t: torch.Tensor, ws, bs, n_freqs: int = 10,
                         dtype="bfloat16") -> torch.Tensor:
    """The kernel's math in plain PyTorch: bf16 operands are held as f32
    tensors of bf16 values, so every product is an f32 matmul with f32
    accumulation and rounding happens exactly where the kernel rounds."""
    dt = _dtype(dtype)
    if dt == torch.bfloat16:
        def r(t):
            return t.to(torch.bfloat16).to(torch.float32)
    else:
        def r(t):
            return t
    w = [x.to(torch.float32) for x in ws]
    b = [x.to(torch.float32) for x in bs]
    enc = r(encode_rows(xyz_t[0, 0:3].to(torch.float32), n_freqs))
    h = enc
    for i in range(DEPTH):
        acc = w[i] @ h
        if i == SKIP:
            acc = acc + w[DEPTH] @ enc
        h = torch.relu(r(r(acc) + r(b[i])))
    sigma = w[DEPTH + 1] @ h + b[DEPTH + 1]
    hf = r(r(w[DEPTH + 2] @ h) + r(b[DEPTH + 2]))
    hd = torch.relu(r(r(w[DEPTH + 3] @ hf) + r(b[DEPTH + 3])))
    rgb = torch.sigmoid(w[DEPTH + 4] @ hd + b[DEPTH + 4])
    out = torch.cat([rgb[0:3], sigma[0:1], torch.zeros_like(rgb[0:4])], dim=0)
    return out[None]


def fused_nerf_fwd(xyz_t: torch.Tensor, ws, bs, n_freqs: int = 10,
                   dtype="bfloat16") -> torch.Tensor:
    """xyz_t (1, 8, M) rows -> (1, 8, M) [r|g|b|sigma|0..]. Kernel on CUDA
    tensors, plain version on CPU tensors. ws / bs as ``pack_params``
    returns them, in the compute dtype; the kernel reads them as they are
    (the bf16 path needs the encoding block E = enc_rows(n_freqs) to be a
    multiple of 16, as it is for the flagship's 10 frequencies)."""
    dt = _dtype(dtype)
    if xyz_t.dim() != 3 or xyz_t.shape[:2] != (1, 8) \
            or xyz_t.dtype != torch.float32:
        raise ValueError(f"xyz_t must be (1, 8, M) float32, got "
                         f"{tuple(xyz_t.shape)} {xyz_t.dtype}")
    if len(ws) != N_W or len(bs) != N_W:
        raise ValueError(f"expected {N_W} packed weights and biases")
    if xyz_t.device.type == "cpu":
        return fused_nerf_fwd_plain(xyz_t, ws, bs, n_freqs, dt)
    E = enc_rows(n_freqs)
    if any(w.dtype != dt for w in ws) or any(b.dtype != torch.float32
                                            for b in bs):
        raise ValueError(f"packed weights must be {dt} and biases float32")
    if dt == torch.bfloat16 and E % 16:
        raise ValueError(f"the bf16 kernel takes a 16-aligned encoding "
                         f"block; n_freqs={n_freqs} gives {E} rows")
    M = xyz_t.shape[-1]
    out = torch.empty((1, 8, M), dtype=torch.float32, device=xyz_t.device)
    if M == 0:
        return out
    xyz_t = xyz_t.contiguous()
    _build.check_cuda("fused_nerf_fwd", xyz_t, *ws, *bs)
    w_ptrs = (ctypes.c_void_p * N_W)(*[t.data_ptr() for t in ws])
    b_ptrs = (ctypes.c_void_p * N_W)(*[t.data_ptr() for t in bs])
    _build.kernel_library().call(
        "animnerf_fused_mlp_fwd", xyz_t.data_ptr(), ctypes.addressof(w_ptrs),
        ctypes.addressof(b_ptrs), out.data_ptr(), M, n_freqs, E,
        0 if dt == torch.bfloat16 else 1, _build.stream_of(xyz_t))
    _build.LAUNCHES["fused_mlp"] += 1
    return out


def fused_nerf_rows(rows: torch.Tensor, ws, bs, n_freqs: int = 10,
                    dtype="bfloat16") -> torch.Tensor:
    """rows (B, 8, N) with xyz in rows 0..2 -> (B, 8, N) [r|g|b|sigma|0..];
    batch elements ride the point axis back to back."""
    B, _, N = rows.shape
    flat = rows.to(torch.float32).transpose(0, 1).reshape(1, 8, B * N)
    out = fused_nerf_fwd(flat, ws, bs, n_freqs, dtype)
    return out.reshape(8, B, N).transpose(0, 1)
