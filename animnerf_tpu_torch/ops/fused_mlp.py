"""Fused positional-encoding + canonical NeRF MLP, forward and backward:
CUDA kernels plus plain versions.

Counterpart of ``animnerf_tpu/ops/fused_mlp.py`` (``pack_params``,
``fused_nerf_fwd``, ``fused_nerf_bwd``, the custom VJP and
``fused_nerf_rows``): xyz rows (1, 8, M) [x|y|z|..] -> (1, 8, M) rows
[r|g|b|sigma|0 0 0 0] f32, differentiable through the xyz rows and the
packed weights and biases (``FusedNerf``, whose backward is
``fused_nerf_bwd``).

Architecture (the flagship field, ``use_view=False``, no codes): 8x256
ReLU trunk with the skip at layer 4 as a split product, sigma head,
xyz_final (no ReLU), dir_0 (128) + ReLU, rgb (3) + sigmoid. In bfloat16
the rounding points are those of the TPU kernel (ops/fused_mlp.py:160-179
there): encoding cast to bf16, each trunk layer relu(bf16(bf16(acc) +
bf16(b))), sigma and rgb from f32 accumulators and f32 biases, hf and hd
rounded like a trunk layer (hf without ReLU). In float32 nothing is
rounded. The backward's rounding points are those of the TPU kernel's
``_bwd_kernel`` (ops/fused_mlp.py:247-307 there), see ``fused_nerf_bwd_plain``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from animnerf_tpu_torch.models.embedding import positional_encoding
from animnerf_tpu_torch.ops import _build

WIDTH = 256
DEPTH = 8
SKIP = 4
DIR_W = 128
N_W = DEPTH + 5  # trunk 0..7, skip-enc half, sigma, xyz_final, dir_0, rgb
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# points per pass of its activation scratch (5.2 GB in bf16): large enough
# that the weight-gradient pass's per-split partials (105 MB a chunk) stay
# a few percent of the scratch it reads
BWD_CHUNK = 1 << 19
SLAB_COLS = 64  # reduction columns of a weight slab: one 128-byte swizzle row
# the bf16 kernels form 2^j as an int shift, and the forward's shared
# memory holds up to 192 encoding columns: n_freqs 0..31
MAX_FREQS = 31
# the backward kernels' encoding blocks are 64 or 128 columns: n_freqs
# 0..20, every encoding the fused field takes (3 + 6 n_freqs <= 128,
# models/anim_nerf.py::use_fused_mlp)
MAX_BWD_FREQS = 20


def enc_rows(n_freqs: int) -> int:
    """Padded row count of the encoding block (as the JAX package)."""
    return max(8, -(-(3 + 6 * n_freqs) // 8) * 8)


def enc_cols(n_freqs: int) -> int:
    """Encoding columns of the bf16 kernels: enc_rows(n_freqs) rounded up
    to a multiple of 64 (their products read the encoding in 64-column
    blocks), the padding zero; 64 for the flagship's 10 frequencies."""
    if not 0 <= n_freqs <= MAX_FREQS:
        raise ValueError(f"the bf16 kernels take n_freqs 0..{MAX_FREQS}, "
                         f"got {n_freqs}")
    return _scratch_cols(n_freqs)


def _scratch_cols(n_freqs: int) -> int:
    """enc_rows rounded up to 64: the encoding columns of the kernels
    (``enc_cols``) and of the plain backward's scratch at any n_freqs."""
    return -(-enc_rows(n_freqs) // SLAB_COLS) * SLAB_COLS


class BwdLayout(NamedTuple):
    """The backward's two encoding widths at one n_freqs."""
    rows: int  # enc_rows: columns of dW_0 and dW_8 (pack_params' shapes)
    cols: int  # enc_cols: the encoding block of the scratch and the kernels


def bwd_layout(n_freqs: int) -> BwdLayout:
    """The backward kernels' layout at n_freqs 0..20: the scratch's
    encoding array is ``cols`` wide (64 up to n_freqs 10, 128 above; the
    columns from 3 + 6 n_freqs zero), the weight gradients of layers 0 and
    8 are ``rows`` wide."""
    if not 0 <= n_freqs <= MAX_BWD_FREQS:
        raise ValueError(f"the backward kernels take n_freqs "
                         f"0..{MAX_BWD_FREQS}, got {n_freqs}")
    return BwdLayout(enc_rows(n_freqs), enc_cols(n_freqs))


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


def _check_image(image, ws):
    """A prebuilt (image, offsets) of ws, as ``kernel_image`` returns it
    (both layouts have the same part offsets)."""
    img, offs = image
    parts, total = image_layout(_image_weights(ws))
    if img.dtype != ws[0].dtype or img.device != ws[0].device \
            or img.numel() != total or not img.is_contiguous() \
            or list(offs) != _part_offsets(parts):
        raise ValueError("the weight image does not match the packed "
                         "weights (build it with kernel_image(ws))")
    return img, (ctypes.c_int * (2 * N_W))(*offs)


def fused_nerf_fwd(xyz_t: torch.Tensor, ws, bs, n_freqs: int = 10,
                   dtype="bfloat16", image=None) -> torch.Tensor:
    """xyz_t (1, 8, M) rows -> (1, 8, M) [r|g|b|sigma|0..]. Kernel on CUDA
    tensors, plain version on CPU tensors. ws / bs as ``pack_params``
    returns them, in the compute dtype. The kernels read the weights from
    their image: ``image`` is ``kernel_image(ws)`` built once by a caller
    whose weights do not change (built here when None); they take n_freqs
    0..31 (``enc_cols``)."""
    dt = _dtype(dtype)
    if xyz_t.dim() != 3 or xyz_t.shape[:2] != (1, 8) \
            or xyz_t.dtype != torch.float32:
        raise ValueError(f"xyz_t must be (1, 8, M) float32, got "
                         f"{tuple(xyz_t.shape)} {xyz_t.dtype}")
    if len(ws) != N_W or len(bs) != N_W:
        raise ValueError(f"expected {N_W} packed weights and biases")
    if xyz_t.device.type == "cpu":
        return fused_nerf_fwd_plain(xyz_t, ws, bs, n_freqs, dt)
    if any(w.dtype != dt for w in ws) or any(b.dtype != torch.float32
                                            for b in bs):
        raise ValueError(f"packed weights must be {dt} and biases float32")
    bf16 = dt == torch.bfloat16
    E = enc_cols(n_freqs)
    if ws[0].shape[1] != enc_rows(n_freqs):
        raise ValueError(f"n_freqs={n_freqs} gives {enc_rows(n_freqs)} "
                         f"encoding rows, the weights have {ws[0].shape[1]}")
    M = xyz_t.shape[-1]
    out = torch.empty((1, 8, M), dtype=torch.float32, device=xyz_t.device)
    if M == 0:
        return out
    xyz_t = xyz_t.contiguous()
    _build.check_cuda("fused_nerf_fwd", xyz_t, *ws, *bs)
    img, img_offs = _check_image(image if image is not None
                                 else kernel_image(ws), ws)
    w_ptrs = (ctypes.c_void_p * N_W)(*[t.data_ptr() for t in ws])
    b_ptrs = (ctypes.c_void_p * N_W)(*[t.data_ptr() for t in bs])
    _build.kernel_library().call(
        "animnerf_fused_mlp_fwd", xyz_t.data_ptr(), ctypes.addressof(w_ptrs),
        ctypes.addressof(b_ptrs), img.data_ptr(), ctypes.addressof(img_offs),
        out.data_ptr(), M, n_freqs, E, 0 if bf16 else 1,
        _build.stream_of(xyz_t))
    _build.LAUNCHES["fused_mlp"] += 1
    if not bf16:
        _build.LAUNCHES["fused_mlp_f32"] += 1
    return out


def _rounder(dt: torch.dtype):
    if dt == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).to(torch.float32)
    return lambda t: t


# The backward kernel's activation scratch, per chunk of `chunk` points:
# the H arrays (each layer's bf16 input: 0 enc (bwd_layout(n).cols, zero
# from 3 + 6 n) | 1..8 h0..h7 | 9 hf |
# 10 hd) then the G arrays (each layer's output cotangent: 0..7 d0..d7 |
# 8 d_hf | 9 d_hd), each a point-major (chunk, width) block, in the
# compute dtype (csrc/fused_mlp_bwd.cu, "scratch layout"). The head
# cotangents are a (chunk, 4) f32 block [d_rgb_raw 0..2 | d_sigma].
HEAD_COLS = 4
# (layer, G array, H array) of the weight gradients dW_l = G^T H
WGRAD_LAYERS = ((0, 0, 0), (1, 1, 1), (2, 2, 2), (3, 3, 3), (4, 4, 4),
                (5, 5, 5), (6, 6, 6), (7, 7, 7), (8, 4, 0), (10, 8, 8),
                (11, 9, 9))
# the layer whose bias gradient each G array sums
BIAS_OF_G = (0, 1, 2, 3, 4, 5, 6, 7, 10, 11)


def scratch_views(scratch: torch.Tensor, chunk: int, E: int):
    """(H, G): the (chunk, width) views of a flat scratch's 11 + 10
    arrays, E the encoding array's width (``bwd_layout(n).cols``)."""
    views, o = [], 0
    for w in (E,) + (WIDTH,) * 9 + (DIR_W,) + (WIDTH,) * 9 + (DIR_W,):
        views.append(scratch[o:o + chunk * w].view(chunk, w))
        o += chunk * w
    return views[:11], views[11:]


def grad_shapes(E: int):
    """Shapes of dW_0..12 then db_0..12, as pack_params' (ws, bs), E the
    encoding rows (``bwd_layout(n).rows``)."""
    ws = ([(WIDTH, E)] + [(WIDTH, WIDTH)] * (DEPTH - 1)
          + [(WIDTH, E), (8, WIDTH), (WIDTH, WIDTH), (DIR_W, WIDTH),
             (8, DIR_W)])
    bs = [(WIDTH, 1)] * (DEPTH + 1) + [(8, 1), (WIDTH, 1), (DIR_W, 1),
                                       (8, 1)]
    return ws + bs


def bwd_scratch_plain(xyz_t: torch.Tensor, ws, bs, dout: torch.Tensor,
                      n_freqs: int = 10, dtype="bfloat16"):
    """The backward kernel's main part in plain PyTorch (f32 matmuls on
    values rounded where the TPU kernel rounds): the recomputed forward,
    the f32 ReLU masks of the bf16 activations, dgrad rounded to the
    compute dtype after every product, and the encoding chain rule.
    Returns (d_xyz_t (1, 8, M) f32, scratch, heads): the H/G scratch of the
    M points in the compute dtype and their (M, 4) f32 head cotangents, in
    the kernel's layout with chunk = M (the encoding array zero-padded to
    ``bwd_layout(n_freqs).cols`` columns)."""
    dt = _dtype(dtype)
    r = _rounder(dt)
    w = [x.to(torch.float32) for x in ws]
    b = [x.to(torch.float32) for x in bs]
    M = xyz_t.shape[-1]
    coords = xyz_t[0, 0:3].to(torch.float32)
    d = dout[0].to(torch.float32)
    enc_b = r(encode_rows(coords, n_freqs))
    acts = []
    h = enc_b
    for i in range(DEPTH):
        acc = w[i] @ h
        if i == SKIP:
            acc = acc + w[DEPTH] @ enc_b
        h = torch.relu(r(r(acc) + r(b[i])))
        acts.append(h)
    h7 = acts[-1]
    hf = r(r(w[DEPTH + 2] @ h7) + r(b[DEPTH + 2]))
    hd = torch.relu(r(r(w[DEPTH + 3] @ hf) + r(b[DEPTH + 3])))
    s = torch.sigmoid(w[DEPTH + 4] @ hd + b[DEPTH + 4])        # (8, M)
    row = torch.arange(8, device=d.device)[:, None]
    d_rgb_raw = torch.where(row < 3, d, 0.0) * s * (1.0 - s)
    d_sigma8 = torch.where(row == 0, d[3:4], 0.0)

    G = [None] * 10
    d_rgb_b = r(d_rgb_raw)
    d_hd = r(w[DEPTH + 4].t() @ d_rgb_b)
    G[9] = d_hd = torch.where(hd > 0, d_hd, 0.0)
    G[8] = d_hf = r(w[DEPTH + 3].t() @ d_hd)
    d_sig_b = r(d_sigma8)
    d_h = r(w[DEPTH + 1].t() @ d_sig_b + w[DEPTH + 2].t() @ d_hf)
    d_enc = torch.zeros_like(enc_b)
    for i in range(DEPTH - 1, -1, -1):
        G[i] = d_h = torch.where(acts[i] > 0, d_h, 0.0)
        if i == SKIP:
            d_enc = d_enc + w[DEPTH].t() @ d_h
        d_h = r(w[i].t() @ d_h)
    d_enc = d_enc + d_h

    # encoding chain rule: d_x = d_enc[x] + sum_j f_j (cos(f_j x) d_sin
    # - sin(f_j x) d_cos)
    rows = []
    for c in range(3):
        x = coords[c]
        dc = d_enc[c]
        for j in range(n_freqs):
            f = float(2.0 ** j)
            dc = dc + f * (torch.cos(f * x) * d_enc[3 + 6 * j + c]
                           - torch.sin(f * x) * d_enc[3 + 6 * j + 3 + c])
        rows.append(dc)
    d_xyz = torch.cat([torch.stack(rows), coords.new_zeros(5, M)])[None]
    enc_s = torch.nn.functional.pad(
        enc_b, (0, 0, 0, _scratch_cols(n_freqs) - enc_b.shape[0]))
    H = [enc_s] + acts + [hf, hd]
    scratch = torch.cat([t.t().reshape(-1) for t in H + G]).to(dt)
    heads = torch.cat([d_rgb_raw[0:3], d[3:4]]).t().contiguous()
    return d_xyz, scratch, heads


def wgrad_from_scratch_plain(scratch: torch.Tensor, heads: torch.Tensor,
                             rows: int, chunk: int, acc_dtype=torch.float32,
                             n_freqs: int = 10) -> torch.Tensor:
    """The weight-gradient pass in plain PyTorch: the flat gradients (f32,
    dW_0..12 then db_0..12 in pack_params' shapes at n_freqs, padded to a
    multiple of 64 as the kernel's) over points [0, rows) of a chunk's
    scratch (its encoding array ``bwd_layout(n_freqs).cols`` wide) and head
    cotangents (``heads``: at least chunk * 4 floats). dW_l = G_l^T H_l
    (layers 0 and 8 over the encoding's first enc_rows columns), db_l =
    the sum of G_l; the heads from their cotangents, rounded to bf16 for a
    bf16 scratch (the TPU kernel's d_rgb_b, d_sig_b), their bias gradients
    from the f32 values; matmuls and sums in acc_dtype."""
    E = scratch.numel() // chunk - 2 * (9 * WIDTH + DIR_W)
    if E != _scratch_cols(n_freqs):
        raise ValueError(f"the scratch's encoding array is {E} wide; "
                         f"n_freqs={n_freqs} takes {_scratch_cols(n_freqs)}")
    ER = enc_rows(n_freqs)
    H, G = scratch_views(scratch, chunk, E)
    H = [H[0][:, :ER]] + H[1:]
    hc = heads.reshape(-1)[:chunk * HEAD_COLS].view(chunk, HEAD_COLS)
    hc = hc[:rows].to(acc_dtype)
    if scratch.dtype == torch.bfloat16:
        def rb(t):
            return t.to(torch.bfloat16).to(acc_dtype)
    else:
        def rb(t):
            return t

    def f(t):
        return t[:rows].to(acc_dtype)

    shapes = grad_shapes(ER)
    out = [torch.zeros(sh, dtype=acc_dtype, device=scratch.device)
           for sh in shapes]
    for l, g, h in WGRAD_LAYERS:
        out[l] = f(G[g]).t() @ f(H[h])
    for g, l in enumerate(BIAS_OF_G):
        out[N_W + l][:, 0] = f(G[g]).sum(0)
    out[DEPTH + 1][0] = rb(hc[:, 3]) @ f(H[8])
    out[DEPTH + 4][0:3] = rb(hc[:, 0:3]).t() @ f(H[10])
    out[N_W + DEPTH + 1][0, 0] = hc[:, 3].sum()
    out[N_W + DEPTH + 4][0:3, 0] = hc[:, 0:3].sum(0)
    flat = torch.cat([t.reshape(-1) for t in out]).to(torch.float32)
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % 64))


def _split_grads(flat: torch.Tensor, ws, bs):
    """The flat gradients as (d_ws, d_bs) views shaped like (ws, bs)."""
    offs = _offsets(ws, bs)
    if offs[-1] + bs[-1].numel() > flat.numel():
        raise ValueError("packed weight shapes do not match the backward "
                         "kernel's gradient layout")
    parts = [flat[o:o + t.numel()].view(t.shape)
             for o, t in zip(offs, tuple(ws) + tuple(bs))]
    return tuple(parts[:N_W]), tuple(parts[N_W:])


def fused_nerf_bwd_plain(xyz_t: torch.Tensor, ws, bs, dout: torch.Tensor,
                         n_freqs: int = 10, dtype="bfloat16"):
    """The backward kernel's math in plain PyTorch: ``bwd_scratch_plain``
    (the recomputed forward, dgrad and the encoding chain rule into the
    kernel's scratch) then ``wgrad_from_scratch_plain`` (weight gradients
    from the rounded operands, bias gradients of the f32 head cotangents).
    Returns (d_xyz_t (1, 8, M), d_ws, d_bs), all float32, shaped like
    (ws, bs)."""
    M = xyz_t.shape[-1]
    d_xyz, scratch, heads = bwd_scratch_plain(xyz_t, ws, bs, dout, n_freqs,
                                              dtype)
    if M == 0:
        flat = torch.zeros(sum(t.numel() for t in tuple(ws) + tuple(bs)),
                           device=xyz_t.device)
    else:
        flat = wgrad_from_scratch_plain(scratch, heads, M, M,
                                        n_freqs=n_freqs)
    return (d_xyz, *_split_grads(flat, ws, bs))


# The bf16 kernels' weight image: each weight they stream, as the exact
# shared-memory bytes of the slabs their wgmma products read
# (csrc/mlp_wgmma.cuh). A part is an (R x C) operand, R output rows by C
# reduction columns: W_l itself (N x K) for the forward's out = in . W_l^T
# (read by the forward and the backward's recompute), W_l^T (K x N) for the
# dgrad's d_in = d_out . W_l. The encoding columns of layers 0 and 8 are
# zero-padded to enc_cols. The heads (layers 9 and 12) run on the CUDA
# cores and are read from the packed weights as they are.
IMAGE_LAYERS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11)
IMAGE_PARTS = tuple((l, False) for l in IMAGE_LAYERS) + tuple(
    (l, True) for l in IMAGE_LAYERS)  # (layer, transposed)


def image_offset(R: int, C: int) -> torch.Tensor:
    """(R, C) int64 element offsets of an (R x C) bf16 operand in its image:
    row tiles of NT = min(R, 128) rows, each cut into 64-column slabs
    (slab index row_tile * C / 64 + col // 64, NT * 64 elements each);
    inside a slab, row r at r * 64 and the 8-element chunk j of the row's
    64 columns at chunk j ^ (r % 8) (the 128-byte swizzle)."""
    nt = min(R, 128)
    r = torch.arange(R)[:, None]
    k = torch.arange(C)[None, :]
    rr, kk = r % nt, k % SLAB_COLS
    slab = (r // nt) * (C // SLAB_COLS) + k // SLAB_COLS
    return (slab * nt * SLAB_COLS + rr * SLAB_COLS
            + (((kk // 8) ^ (rr % 8)) * 8) + kk % 8)


def image_layout(ws):
    """[(layer, transposed, R, C, offset)] of IMAGE_PARTS in the image, and
    its length in elements."""
    parts, o = [], 0
    for l, t in IMAGE_PARTS:
        N, K = ws[l].shape
        R, C = (K, N) if t else (N, K)
        parts.append((l, t, R, C, o))
        o += R * C
    return parts, o


_IMAGE_INDEX = {}


def _image_index(ws, f32: bool = False) -> torch.Tensor:
    """Index into the concatenated flat weights for every image element,
    in the bf16 kernels' slab layout or (``f32``) the f32 kernels'
    reduction-major one (cached per device, shapes and layout)."""
    shapes = tuple(tuple(w.shape) for w in ws)
    key = (str(ws[0].device), shapes, f32)
    if key not in _IMAGE_INDEX:
        base = [0]
        for w in ws:
            base.append(base[-1] + w.numel())
        parts, total = image_layout(ws)
        offset = f32_image_offset if f32 else image_offset
        index = torch.empty(total, dtype=torch.int64)
        for l, t, R, C, o in parts:
            r = torch.arange(R)[:, None]
            k = torch.arange(C)[None, :]
            K = ws[l].shape[1]
            src = base[l] + (k * K + r if t else r * K + k)
            index[o + offset(R, C).reshape(-1)] = src.reshape(-1)
        _IMAGE_INDEX[key] = index.to(ws[0].device)
    return _IMAGE_INDEX[key]


def _image_weights(ws):
    """ws with the encoding columns of layers 0 and 8 zero-padded to a
    multiple of 64."""
    E = ws[0].shape[1]
    pad = -(-E // SLAB_COLS) * SLAB_COLS - E
    if pad == 0:
        return tuple(ws)
    return tuple(torch.nn.functional.pad(w, (0, pad)) if l in (0, DEPTH)
                 else w for l, w in enumerate(ws))


def _part_offsets(parts):
    offs = [-1] * (2 * N_W)
    for l, t, _, _, o in parts:
        offs[N_W * t + l] = o
    return offs


def weight_image(ws):
    """(image (n,) in the weights' dtype, offsets): the packed weights
    gathered into the bf16 kernels' slab image (layers 0 and 8 zero-padded
    to a multiple of 64 columns), and the element offset of each layer's
    part, fwd[0..12] then bwd[0..12] (-1 where absent)."""
    ws = _image_weights(ws)
    image = torch.cat([w.reshape(-1) for w in ws])[_image_index(ws)]
    return image, _part_offsets(image_layout(ws)[0])


def unpack_image(image: torch.Tensor, R: int, C: int, offset: int,
                 f32: bool = False) -> torch.Tensor:
    """The (R x C) operand at `offset` of an image (``f32``: of an
    ``f32_image``), back in row-major."""
    offs = f32_image_offset(R, C) if f32 else image_offset(R, C)
    return image[offset + offs.to(image.device)]


# The f32 kernels' weight image (csrc/mlp_f32.cu, mlp_f32_tile.cuh): the
# same parts at the same offsets as ``weight_image``, each (R x C) operand
# (R output rows by C reduction columns) stored reduction-major, i.e.
# column-major: the forward part of layer l is W_l^T (K x N row-major,
# [k][n]), the dgrad part W_l itself (N x K, [n][k]), so a slab of KS = 16
# reduction rows is KS whole rows, one contiguous block, read in order by
# the kernels' cp.async ring. Encoding columns zero-padded to 64 as in
# ``weight_image``.
F32_KS = 16  # reduction rows of an f32 slab


def f32_image_offset(R: int, C: int) -> torch.Tensor:
    """(R, C) int64 element offsets of an (R x C) operand in the f32
    image: element (r, c) at c * R + r."""
    return torch.arange(C)[None, :] * R + torch.arange(R)[:, None]


def f32_image(ws):
    """(image (n,) float32, offsets): the packed f32 weights gathered into
    the f32 kernels' reduction-major image (layers 0 and 8 zero-padded to
    a multiple of 64 columns), with ``weight_image``'s part offsets."""
    ws = _image_weights(ws)
    image = torch.cat([w.reshape(-1) for w in ws])[_image_index(ws, True)]
    return image, _part_offsets(image_layout(ws)[0])


def kernel_image(ws):
    """The image the MLP kernels read for packed weights ws in their
    compute dtype: ``weight_image`` in bf16, ``f32_image`` in f32."""
    if ws[0].dtype == torch.float32:
        return f32_image(ws)
    return weight_image(ws)


# Shared memory of the f32 kernels' blocks (csrc/mlp_f32.cu: FwdSmem,
# BwdSmem; the C entry animnerf_mlp_f32_smem reports the same): 64 points
# of two 256-row activation buffers, the encoding block, the forward's
# sigma partials or the backward's ReLU bits (9 layers x 256 threads x 8
# B) and head cotangents, then as many 16 KB slab stages as fit, up to 4.
F32_SMEM_MAX = 232448
F32_SLAB_BYTES = F32_KS * WIDTH * 4
F32_ACT_BYTES = WIDTH * 64 * 4


def f32_smem(n_freqs: int, backward: bool = False):
    """(encoding block, ring stages, bytes) of the f32 forward (n_freqs
    0..31, encoding blocks of 64, 128 or 192) or backward main kernel
    (0..20: 64 or 128) at n_freqs; the instantiation the wrappers pick
    is the block ``enc_cols(n_freqs)``."""
    if backward:
        ec = bwd_layout(n_freqs).cols
        fixed = 2 * F32_ACT_BYTES + ec * 64 * 4 + 9 * 256 * 8 + 64 * 4 * 4
    else:
        ec = enc_cols(n_freqs)
        fixed = 2 * F32_ACT_BYTES + ec * 64 * 4 + 4 * 64 * 4
    stages = min(4, (F32_SMEM_MAX - fixed) // F32_SLAB_BYTES)
    return ec, stages, fixed + stages * F32_SLAB_BYTES


def _offsets(ws, bs):
    """Offsets of dW_0..12 then db_0..12 in the backward kernel's flat f32
    gradient buffer."""
    offs, o = [], 0
    for t in tuple(ws) + tuple(bs):
        offs.append(o)
        o += t.numel()
    return offs


def _bwd_sizes(chunk: int, n_freqs: int):
    """(scratch elements, head floats, partial floats, gradient floats) of
    the backward kernel at `chunk` points and n_freqs."""
    sizes = (ctypes.c_longlong * 4)()
    _build.kernel_library().call("animnerf_fused_mlp_bwd_sizes", chunk,
                                 bwd_layout(n_freqs).rows,
                                 ctypes.addressof(sizes))
    return tuple(sizes)


def _check_bwd_args(xyz_t, ws, bs, dout) -> None:
    if xyz_t.dim() != 3 or xyz_t.shape[:2] != (1, 8) \
            or dout.shape != xyz_t.shape:
        raise ValueError(f"xyz_t and dout must be (1, 8, M), got "
                         f"{tuple(xyz_t.shape)} and {tuple(dout.shape)}")
    if len(ws) != N_W or len(bs) != N_W:
        raise ValueError(f"expected {N_W} packed weights and biases")


def fused_nerf_bwd_buffers(xyz_t: torch.Tensor, ws, bs, dout: torch.Tensor,
                           n_freqs: int = 10, dtype="bfloat16", image=None):
    """The backward kernel on CUDA tensors (``fused_nerf_bwd`` without its
    CPU path): (d_xyz_t, grads, scratch, heads, chunk), grads the flat f32
    gradients, scratch and heads the buffers as the last chunk of `chunk`
    points left them (with M <= chunk, all of M's points)."""
    dt = _dtype(dtype)
    _check_bwd_args(xyz_t, ws, bs, dout)
    layout = bwd_layout(n_freqs)
    if ws[0].shape[1] != layout.rows:
        raise ValueError(f"n_freqs={n_freqs} gives {layout.rows} encoding "
                         f"rows, the weights have {ws[0].shape[1]}")
    if any(w.dtype != dt for w in ws) or any(b.dtype != torch.float32
                                            for b in bs):
        raise ValueError(f"packed weights must be {dt} and biases float32")
    if xyz_t.dtype != torch.float32 or dout.dtype != torch.float32:
        raise ValueError("xyz_t and dout must be float32")
    xyz_t, dout = xyz_t.detach().contiguous(), dout.detach().contiguous()
    ws = [w.detach().contiguous() for w in ws]
    bs = [b.detach().contiguous() for b in bs]
    _build.check_cuda("fused_nerf_bwd", xyz_t, dout, *ws, *bs)
    dev = xyz_t.device
    M = xyz_t.shape[-1]
    chunk = min(-(-max(M, 1) // 128) * 128, BWD_CHUNK)
    n_scratch, n_heads, n_part, total = _bwd_sizes(chunk, n_freqs)
    # every row of d_xyz, every partial entry and every gradient is written
    # by the kernels
    d_xyz = torch.empty((1, 8, M), dtype=torch.float32, device=dev)
    scratch = torch.empty(n_scratch, dtype=dt, device=dev)
    heads = torch.empty(n_heads, dtype=torch.float32, device=dev)
    if M == 0:
        return (d_xyz, torch.zeros(total, dtype=torch.float32, device=dev),
                scratch, heads, chunk)
    partials = torch.empty(n_part, dtype=torch.float32, device=dev)
    grads = torch.empty(total, dtype=torch.float32, device=dev)
    w_ptrs = (ctypes.c_void_p * N_W)(*[t.data_ptr() for t in ws])
    b_ptrs = (ctypes.c_void_p * N_W)(*[t.data_ptr() for t in bs])
    image, img_offs = _check_image(image if image is not None
                                   else kernel_image(ws), ws)
    _build.kernel_library().call(
        "animnerf_fused_mlp_bwd", xyz_t.data_ptr(), dout.data_ptr(),
        ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs),
        image.data_ptr(), ctypes.addressof(img_offs),
        d_xyz.data_ptr(), grads.data_ptr(), scratch.data_ptr(),
        heads.data_ptr(), partials.data_ptr(), M, chunk, n_freqs,
        layout.rows, 0 if dt == torch.bfloat16 else 1,
        _build.stream_of(xyz_t))
    _build.LAUNCHES["fused_mlp_bwd"] += 1
    if dt == torch.bfloat16:  # its weight gradients: the wgmma pass
        _build.LAUNCHES["fused_mlp_wgrad"] += 1
    else:
        _build.LAUNCHES["fused_mlp_bwd_f32"] += 1
    return d_xyz, grads, scratch, heads, chunk


def fused_nerf_bwd(xyz_t: torch.Tensor, ws, bs, dout: torch.Tensor,
                   n_freqs: int = 10, dtype="bfloat16", image=None):
    """VJP of ``fused_nerf_fwd``: (d_xyz_t (1, 8, M) f32, d_ws, d_bs) f32,
    shaped like (ws, bs). Kernel on CUDA tensors (deterministic: per-split
    partial sums reduced in a fixed order), plain version on CPU tensors.
    The kernels take n_freqs 0..20 (``bwd_layout``: encoding blocks of 64
    or 128 columns) and read ``image`` (``kernel_image(ws)``, built here
    when None)."""
    _check_bwd_args(xyz_t, ws, bs, dout)
    if xyz_t.device.type == "cpu":
        return fused_nerf_bwd_plain(xyz_t, ws, bs, dout, n_freqs,
                                    _dtype(dtype))
    d_xyz, grads, *_ = fused_nerf_bwd_buffers(xyz_t, ws, bs, dout, n_freqs,
                                              dtype, image)
    return (d_xyz, *_split_grads(grads, ws, bs))


def fused_nerf_wgrad(scratch: torch.Tensor, heads: torch.Tensor, rows: int,
                     chunk: int, n_freqs: int = 10) -> torch.Tensor:
    """The bf16 weight-gradient pass alone: the flat f32 gradients over
    points [0, rows) of a chunk's scratch (bf16, the kernel's layout at
    n_freqs: ``bwd_layout``) and head cotangents (the first chunk * 4
    floats of ``heads``; on the card a buffer of the kernel's head size, as
    ``fused_nerf_bwd_buffers`` returns it, whose tail the pass writes).
    Kernel on CUDA tensors, plain version on CPU tensors."""
    if not 0 < rows <= chunk:
        raise ValueError(f"rows must be in 1..chunk, got {rows} of {chunk}")
    if scratch.device.type == "cpu":
        return wgrad_from_scratch_plain(scratch, heads, rows, chunk,
                                        n_freqs=n_freqs)
    if chunk % 128:
        raise ValueError(f"chunk must be a multiple of 128, got {chunk}")
    n_scratch, n_heads, n_part, total = _bwd_sizes(chunk, n_freqs)
    if scratch.dtype != torch.bfloat16 or scratch.numel() != n_scratch:
        raise ValueError(f"scratch must be {n_scratch} bf16 elements "
                         f"(chunk {chunk}, n_freqs {n_freqs})")
    if heads.dtype != torch.float32 or heads.numel() != n_heads:
        raise ValueError(f"heads must be {n_heads} float32 values")
    _build.check_cuda("fused_nerf_wgrad", scratch, heads)
    partials = torch.empty(n_part, dtype=torch.float32, device=scratch.device)
    grads = torch.empty(total, dtype=torch.float32, device=scratch.device)
    _build.kernel_library().call(
        "animnerf_mlp_wgrad", scratch.data_ptr(), heads.data_ptr(),
        partials.data_ptr(), grads.data_ptr(), rows, chunk,
        bwd_layout(n_freqs).rows, _build.stream_of(scratch))
    _build.LAUNCHES["fused_mlp_wgrad"] += 1
    return grads


class FusedNerf(torch.autograd.Function):
    """Differentiable fused MLP: forward ``fused_nerf_fwd``, backward
    ``fused_nerf_bwd``. The weights arrive in float32 (packed from the live
    parameters) and are cast to the compute dtype inside, so their
    gradients stay unrounded float32, as the JAX custom VJP returns them.
    In bf16 on the card the weight image is built once, here, and serves
    both kernels."""

    @staticmethod
    def forward(ctx, xyz_t, n_freqs, dtype, *wb):
        dt = _dtype(dtype)
        ws = tuple(w.detach().to(dt).contiguous() for w in wb[:N_W])
        bs = tuple(b.detach().contiguous() for b in wb[N_W:])
        ctx.n_freqs, ctx.dtype = n_freqs, dt
        ctx.image = (kernel_image(ws) if xyz_t.device.type != "cpu"
                     else None)
        ctx.save_for_backward(xyz_t, *ws, *bs)
        return fused_nerf_fwd(xyz_t.detach(), ws, bs, n_freqs, dt,
                              ctx.image)

    @staticmethod
    def backward(ctx, dout):
        xyz_t, *wb = ctx.saved_tensors
        d_xyz, d_ws, d_bs = fused_nerf_bwd(xyz_t, wb[:N_W], wb[N_W:],
                                           dout.contiguous(), ctx.n_freqs,
                                           ctx.dtype, ctx.image)
        return (d_xyz, None, None, *d_ws, *d_bs)


def fused_nerf(xyz_t: torch.Tensor, ws, bs, n_freqs: int = 10,
               dtype="bfloat16", image=None) -> torch.Tensor:
    """fused_nerf_fwd, through ``FusedNerf`` when autograd needs it (which
    builds its own weight image; ``image`` serves the no-grad path)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xyz_t, *ws, *bs)):
        return FusedNerf.apply(xyz_t, n_freqs, dtype, *ws, *bs)
    return fused_nerf_fwd(xyz_t, ws, bs, n_freqs, dtype, image)


def fused_nerf_rows(rows: torch.Tensor, ws, bs, n_freqs: int = 10,
                    dtype="bfloat16", image=None) -> torch.Tensor:
    """rows (B, 8, N) with xyz in rows 0..2 -> (B, 8, N) [r|g|b|sigma|0..];
    batch elements ride the point axis back to back. Differentiable."""
    B, _, N = rows.shape
    flat = rows.to(torch.float32).transpose(0, 1).reshape(1, 8, B * N)
    out = fused_nerf(flat, ws, bs, n_freqs, dtype, image)
    return out.reshape(8, B, N).transpose(0, 1)
