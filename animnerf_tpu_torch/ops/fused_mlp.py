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

import torch

from animnerf_tpu_torch.models.embedding import positional_encoding
from animnerf_tpu_torch.ops import _build

WIDTH = 256
DEPTH = 8
SKIP = 4
DIR_W = 128
N_W = DEPTH + 5  # trunk 0..7, skip-enc half, sigma, xyz_final, dir_0, rgb
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
BWD_E = 64  # the backward kernel's encoding block (n_freqs 9 or 10)
BWD_CHUNK = 131072  # points per pass of its activation scratch
SLAB_COLS = 64  # reduction columns of a weight slab: one 128-byte swizzle row
# the bf16 kernels form 2^j as an int shift, and the forward's shared
# memory holds up to 192 encoding columns: n_freqs 0..31
MAX_FREQS = 31


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
    return -(-enc_rows(n_freqs) // SLAB_COLS) * SLAB_COLS


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
    """A prebuilt (image, offsets) of ws, as ``weight_image`` returns it."""
    img, offs = image
    parts, total = image_layout(_image_weights(ws))
    if img.dtype != ws[0].dtype or img.device != ws[0].device \
            or img.numel() != total or not img.is_contiguous() \
            or list(offs) != _part_offsets(parts):
        raise ValueError("the weight image does not match the packed "
                         "weights (build it with weight_image(ws))")
    return img, (ctypes.c_int * (2 * N_W))(*offs)


def fused_nerf_fwd(xyz_t: torch.Tensor, ws, bs, n_freqs: int = 10,
                   dtype="bfloat16", image=None) -> torch.Tensor:
    """xyz_t (1, 8, M) rows -> (1, 8, M) [r|g|b|sigma|0..]. Kernel on CUDA
    tensors, plain version on CPU tensors. ws / bs as ``pack_params``
    returns them, in the compute dtype. The bf16 kernel reads the weights
    from their slab image: ``image`` is ``weight_image(ws)`` built once by
    a caller whose weights do not change (built here when None), and
    takes n_freqs 0..31 (``enc_cols``)."""
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
    E = enc_cols(n_freqs) if bf16 else enc_rows(n_freqs)
    if ws[0].shape[1] != enc_rows(n_freqs):
        raise ValueError(f"n_freqs={n_freqs} gives {enc_rows(n_freqs)} "
                         f"encoding rows, the weights have {ws[0].shape[1]}")
    M = xyz_t.shape[-1]
    out = torch.empty((1, 8, M), dtype=torch.float32, device=xyz_t.device)
    if M == 0:
        return out
    xyz_t = xyz_t.contiguous()
    _build.check_cuda("fused_nerf_fwd", xyz_t, *ws, *bs)
    img, img_offs = None, None
    if bf16:
        img, img_offs = _check_image(image if image is not None
                                     else weight_image(ws), ws)
    w_ptrs = (ctypes.c_void_p * N_W)(*[t.data_ptr() for t in ws])
    b_ptrs = (ctypes.c_void_p * N_W)(*[t.data_ptr() for t in bs])
    _build.kernel_library().call(
        "animnerf_fused_mlp_fwd", xyz_t.data_ptr(), ctypes.addressof(w_ptrs),
        ctypes.addressof(b_ptrs), None if img is None else img.data_ptr(),
        None if img_offs is None else ctypes.addressof(img_offs),
        out.data_ptr(), M, n_freqs, E, 0 if bf16 else 1,
        _build.stream_of(xyz_t))
    _build.LAUNCHES["fused_mlp"] += 1
    return out


def _rounder(dt: torch.dtype):
    if dt == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).to(torch.float32)
    return lambda t: t


def fused_nerf_bwd_plain(xyz_t: torch.Tensor, ws, bs, dout: torch.Tensor,
                         n_freqs: int = 10, dtype="bfloat16"):
    """The backward kernel's math in plain PyTorch (f32 matmuls on values
    rounded where the TPU kernel rounds): the recomputed forward, the f32
    ReLU masks of the bf16 activations, dgrad rounded to the compute dtype
    after every product, weight gradients from the rounded operands, bias
    gradients of the f32 head cotangents, and the encoding chain rule.
    Returns (d_xyz_t (1, 8, M), d_ws, d_bs), all float32, shaped like
    (ws, bs)."""
    r = _rounder(_dtype(dtype))
    w = [x.to(torch.float32) for x in ws]
    b = [x.to(torch.float32) for x in bs]
    coords = xyz_t[0, 0:3].to(torch.float32)
    M = coords.shape[-1]
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
    d = dout[0].to(torch.float32)
    row = torch.arange(8, device=d.device)[:, None]
    d_rgb_raw = torch.where(row < 3, d, 0.0) * s * (1.0 - s)
    d_sigma8 = torch.where(row == 0, d[3:4], 0.0)

    dw = [None] * N_W
    db = [None] * N_W
    d_rgb_b = r(d_rgb_raw)
    dw[DEPTH + 4] = d_rgb_b @ hd.t()
    db[DEPTH + 4] = d_rgb_raw.sum(1)
    d_hd = r(w[DEPTH + 4].t() @ d_rgb_b)
    d_hd = torch.where(hd > 0, d_hd, 0.0)
    dw[DEPTH + 3] = d_hd @ hf.t()
    db[DEPTH + 3] = d_hd.sum(1)
    d_hf = r(w[DEPTH + 3].t() @ d_hd)
    dw[DEPTH + 2] = d_hf @ h7.t()
    db[DEPTH + 2] = d_hf.sum(1)
    d_sig_b = r(d_sigma8)
    dw[DEPTH + 1] = d_sig_b @ h7.t()
    db[DEPTH + 1] = d_sigma8.sum(1)
    d_h = r(w[DEPTH + 1].t() @ d_sig_b + w[DEPTH + 2].t() @ d_hf)
    d_enc = torch.zeros_like(enc_b)
    for i in range(DEPTH - 1, -1, -1):
        h_in = acts[i - 1] if i > 0 else enc_b
        d_h = torch.where(acts[i] > 0, d_h, 0.0)
        dw[i] = d_h @ h_in.t()
        db[i] = d_h.sum(1)
        if i == SKIP:
            dw[DEPTH] = d_h @ enc_b.t()
            d_enc = d_enc + w[DEPTH].t() @ d_h
        d_h = r(w[i].t() @ d_h)
    d_enc = d_enc + d_h
    db[DEPTH] = torch.zeros_like(b[DEPTH][:, 0])

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
    return (d_xyz, tuple(g.reshape(x.shape) for g, x in zip(dw, ws)),
            tuple(g.reshape(x.shape) for g, x in zip(db, bs)))


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


def _image_index(ws) -> torch.Tensor:
    """Index into the concatenated flat weights for every image element
    (cached per device and shapes)."""
    shapes = tuple(tuple(w.shape) for w in ws)
    key = (str(ws[0].device), shapes)
    if key not in _IMAGE_INDEX:
        base = [0]
        for w in ws:
            base.append(base[-1] + w.numel())
        parts, total = image_layout(ws)
        index = torch.empty(total, dtype=torch.int64)
        for l, t, R, C, o in parts:
            r = torch.arange(R)[:, None]
            k = torch.arange(C)[None, :]
            K = ws[l].shape[1]
            src = base[l] + (k * K + r if t else r * K + k)
            index[o + image_offset(R, C).reshape(-1)] = src.reshape(-1)
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


def unpack_image(image: torch.Tensor, R: int, C: int,
                 offset: int) -> torch.Tensor:
    """The (R x C) operand at `offset` of an image, back in row-major."""
    return image[offset + image_offset(R, C).to(image.device)]


def _offsets(ws, bs):
    """Offsets of dW_0..12 then db_0..12 in the backward kernel's flat f32
    gradient buffer."""
    offs, o = [], 0
    for t in tuple(ws) + tuple(bs):
        offs.append(o)
        o += t.numel()
    return offs


def fused_nerf_bwd(xyz_t: torch.Tensor, ws, bs, dout: torch.Tensor,
                   n_freqs: int = 10, dtype="bfloat16", image=None):
    """VJP of ``fused_nerf_fwd``: (d_xyz_t (1, 8, M) f32, d_ws, d_bs) f32,
    shaped like (ws, bs). Kernel on CUDA tensors (deterministic: per-split
    partial sums reduced in a fixed order), plain version on CPU tensors.
    The kernel takes the flagship's 64-row encoding block (n_freqs 9 or
    10); in bf16 it reads ``image`` (``weight_image(ws)``, built here when
    None)."""
    dt = _dtype(dtype)
    if xyz_t.dim() != 3 or xyz_t.shape[:2] != (1, 8) \
            or dout.shape != xyz_t.shape:
        raise ValueError(f"xyz_t and dout must be (1, 8, M), got "
                         f"{tuple(xyz_t.shape)} and {tuple(dout.shape)}")
    if len(ws) != N_W or len(bs) != N_W:
        raise ValueError(f"expected {N_W} packed weights and biases")
    if xyz_t.device.type == "cpu":
        return fused_nerf_bwd_plain(xyz_t, ws, bs, dout, n_freqs, dt)
    if enc_rows(n_freqs) != BWD_E:
        raise ValueError(f"the backward kernel takes a {BWD_E}-row encoding "
                         f"block; n_freqs={n_freqs} gives {enc_rows(n_freqs)}")
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
    d_xyz = torch.zeros((1, 8, M), dtype=torch.float32, device=dev)
    lib = _build.kernel_library()
    chunk = min(-(-max(M, 1) // 128) * 128, BWD_CHUNK)
    sizes = (ctypes.c_longlong * 4)()
    lib.call("animnerf_fused_mlp_bwd_sizes", chunk, ctypes.addressof(sizes))
    n_scratch, n_heads, n_part, total = sizes
    if M == 0:
        grads = torch.zeros(total, dtype=torch.float32, device=dev)
    else:
        scratch = torch.empty(n_scratch, dtype=dt, device=dev)
        heads = torch.empty(n_heads, dtype=torch.float32, device=dev)
        partials = torch.zeros(n_part, dtype=torch.float32, device=dev)
        grads = torch.empty(total, dtype=torch.float32, device=dev)
        w_ptrs = (ctypes.c_void_p * N_W)(*[t.data_ptr() for t in ws])
        b_ptrs = (ctypes.c_void_p * N_W)(*[t.data_ptr() for t in bs])
        if dt == torch.bfloat16:
            image, img_offs = _check_image(image if image is not None
                                           else weight_image(ws), ws)
        else:
            image = None
            img_offs = (ctypes.c_int * (2 * N_W))(*([-1] * (2 * N_W)))
        lib.call(
            "animnerf_fused_mlp_bwd", xyz_t.data_ptr(), dout.data_ptr(),
            ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs),
            None if image is None else image.data_ptr(),
            ctypes.addressof(img_offs),
            d_xyz.data_ptr(), grads.data_ptr(), scratch.data_ptr(),
            heads.data_ptr(), partials.data_ptr(), M, chunk, n_freqs,
            enc_rows(n_freqs), 0 if dt == torch.bfloat16 else 1,
            _build.stream_of(xyz_t))
        _build.LAUNCHES["fused_mlp_bwd"] += 1
    offs = _offsets(ws, bs)
    if offs[-1] + bs[-1].numel() > total:
        raise ValueError("packed weight shapes do not match the backward "
                         "kernel's gradient layout")
    parts = [grads[o:o + t.numel()].view(t.shape)
             for o, t in zip(offs, tuple(ws) + tuple(bs))]
    return d_xyz, tuple(parts[:N_W]), tuple(parts[N_W:])


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
        ctx.image = (weight_image(ws) if dt == torch.bfloat16
                     and xyz_t.device.type != "cpu" else None)
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
