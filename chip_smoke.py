#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``animnerf_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printed as a JSON line; any failed check raises (exit != 0):
  1. card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from ``animnerf_tpu_torch/csrc``;
  3. one line per kernel, at the serving path's shapes (kNN, warp-blend,
     fused MLP, lane permute) and at the training step's (kNN with the
     tile skip, weighted scatter, fused MLP backward in bf16 and f32),
     inputs from a seed: its max error against its plain PyTorch version
     on the card beside the stated tolerance, kernel / plain /
     library-call times (median of CUDA-event timings after a warm-up)
     and the least time the card could take (bytes or operations over the
     H100's peak); the scatter and the MLP backward also bit-equal across
     two launches, and the bf16 MLP backward's main kernel (recompute +
     dgrad, on wgmma) and weight-gradient kernels timed apart in one
     profiled call;
  4. serving: the trained scale512 checkpoint on the seed-3 SMPL rig, a
     512x512 turntable rendered through ``Renderer.render_stream``,
     launch counts reset just before and read just after; then one more
     view under torch.profiler (device time by kernel, idle share);
  5. serving parity: one view at 96x96 rendered on the card with the
     kernels and on the CPU with the plain versions;
  6. train: the flagship training step of ``bench.py`` (V=6890 / J=24
     seed-0 rig, 8x256 coarse + fine MLPs in bf16, 64 + 32 samples,
     16 x 1024 rays, six-term loss, Adam) through
     ``RowsCompactTrainer.step``: one warm-up step, then 20 timed steps on
     distinct ray batches with the launch counts reset just before and
     read just after, and one more step under torch.profiler; then 30
     steps on one fixed batch, whose loss must fall, with finite losses
     and gradients throughout;
  7. train parity: one step at full width with 2 x 128 rays on the card
     (kernels) and on the CPU (plain versions) from the same parameters
     and noise, in f32 and in bf16: loss terms, gradients per parameter
     group and the parameters after one SGD-momentum step;
  8. SMPL-X kernel lines: the exact kNN and the nearest-vertex distance
     against the seed-0 SMPL-X rig (V=10475, J=55), each bit-equal to its
     plain version on the card;
  9. smplx_serve: the flagship field with random weights from a seed (the
     sigma heads' biases raised so the 0.2 m shell is opaque) on that rig,
     a 512x512 turntable through ``Renderer.render_stream`` with
     ``prepass="exact"``, launch counts reset just before and read just
     after (the packed kNN must not launch), one profiled view, and the
     same views with ``prepass="boxes"``, whose images must agree;
 10. smplx_serve_parity: one 64x64 view with prepass="exact" on the card
     and on the CPU, bf16 and f32;
 11. smplx_train: the bench.py step on the SMPL-X rig with every SMPL-X
     body parameter optimised: one warm-up step, 10 timed steps, one
     profiled step, 20 steps on one fixed batch whose loss must fall;
 12. smplx_train_parity: phase 7 on the SMPL-X rig;
 13. k_neigh = 8 (kernel 8, the packed extract-min kNN, in place of kernel
     1; kernels 2, 5 and 9 at K = 8): kernel lines for ``knn_packed`` at
     K = 8 and K = 4 (the latter bit-equal to kernel 1), warp-blend and
     scatter at K = 8 (in phase 3's lines; the warp-blend on one-hot LBS
     columns) and the exact kNN at K = 8 (in phase 8's). The k_neigh 8
     phases run on the rigs with one-hot LBS weights (``rigid_lbs``): the
     seeded rigs' smooth weights let the confidence gate keep neighbour 0
     alone. k8_serve (the scale512 weights with k_neigh 8, views 3,
     29, 55, launch counts: kernel 8 launched, kernels 1, 7 and 9 not, one
     profiled view); k8_serve_parity (phase 5 at k_neigh 8); k8_train (the
     bench.py step with k_neigh 8: warm-up, 10 timed steps, one profiled,
     20 on one batch whose loss must fall); k8_train_parity (phase 7 at
     k_neigh 8); smplx_k8_parity (phase 10 at k_neigh 8 in f32, launching
     the exact kNN at K = 8);
 14. the matmul-form kNN (kernel 10) at "highest" and "default" against
     its plain version at the kNN tool's shapes, then the port's kNN tool
     (``animnerf_tpu_torch/tools/bench_knn.py``): every row, with the
     launch counts reset just before and read just after;
 15. the kernels summary line, the card line, then the final status line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "docs", "demo", "scale512", "ckpt")
# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
# non-FMA f32 operations (add, mul, min, compare): one per lane per cycle,
# half the FMA peak, which counts an FMA as two
PEAK_F32_NONFMA = PEAK_F32 / 2
PEAK_BYTES = 3.35e12
# chunk size of the plain kNN versions on the card (a (chunk x V) matrix):
# large chunks keep their per-chunk launches few
PLAIN_MAX_ELEMS = 1 << 26
# card vs CPU image bounds per compute dtype: (max |img| difference, PSNR)
PARITY_BOUNDS = (("bfloat16", (5e-2, 40.0)), ("float32", (1e-3, 60.0)))
# the bf16 MLP backward at 2^20 points before its main kernel moved to
# wgmma (H100 80GB HBM3, 700 W): the kernel line's earlier time
PREV_BWD_MS = 55.518


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ------------------------------------------------------------------ setup


def rigid_lbs(body_model):
    """The rig with one-hot LBS weights (the largest entry of each row,
    rigid skinning): neighbours on one bone then pass the warp's
    confidence gate together, where the seeded rigs' smooth weights keep
    neighbour 0 alone and k_neigh would change nothing."""
    import torch

    J = body_model.lbs_weights.shape[1]
    body_model.lbs_weights = torch.nn.functional.one_hot(
        body_model.lbs_weights.argmax(1), J).float()
    return body_model


def scale512_system(ck, device, rigid=False, **cfg):
    """The scale512 weights on the seed-3 rig (``rigid``: with one-hot LBS
    weights), with config overrides."""
    from animnerf_tpu_torch.data.synthetic import make_body_model
    from animnerf_tpu_torch.system import AnimNeRFSystem

    bm = make_body_model(6890, 24, seed=3)
    system = AnimNeRFSystem(dict(ck["cfg"], **cfg),
                            rigid_lbs(bm) if rigid else bm, device=device)
    system.load_anim_nerf(ck["anim_nerf"])
    return system


def scale512(device):
    """The trained scale512 system on the seed-3 rig, its frame params and
    the frame geometry."""
    import torch

    from animnerf_tpu_torch.models.warp import prepare_frame
    from animnerf_tpu_torch.smpl.loader import load_pickle
    from animnerf_tpu_torch.utils.convert import load_checkpoint

    ck = load_checkpoint(CKPT)
    system = scale512_system(ck, device)
    keys = ("betas", "global_orient", "body_pose", "transl")
    frame = load_pickle(os.path.join(CKPT, "smpl_000001.pkl"))
    t = load_pickle(os.path.join(CKPT, "smpl_template.pkl"))
    bp = {k: np.asarray(frame[k], np.float32).reshape(1, -1) for k in keys}
    tmpl = {k: np.asarray(t[k], np.float32).reshape(1, -1) for k in keys}
    with torch.no_grad():
        ctx = prepare_frame(system.body_model,
                            {k: torch.tensor(v, device=device)
                             for k, v in bp.items()},
                            {k: torch.tensor(v, device=device)
                             for k, v in tmpl.items()})
    return ck, system, bp, tmpl, ctx


def frame_rays(H: int, W: int) -> np.ndarray:
    from animnerf_tpu_torch.ops.ray_utils import camera_to_c2w, gen_rays

    f = 1.2 * W
    c2w = camera_to_c2w(np.eye(3), np.array([0.0, 0.0, 3.0]))
    return gen_rays(c2w, H, W, [f, f], 0.1, 10.0).reshape(-1, 8)


# ---------------------------------------------------------------- kernels


def kernel_lines(system, ctx):
    """Check and time each serving kernel at the serving path's shapes."""
    import torch

    from animnerf_tpu_torch.ops.fused_mlp import (
        fused_nerf_fwd,
        fused_nerf_fwd_plain,
        pack_params,
    )
    from animnerf_tpu_torch.ops.knn_kernel import (
        knn_packed,
        knn_packed_plain,
        knn_top4,
        knn_top4_plain,
    )
    from animnerf_tpu_torch.ops.sort_lanes import (
        gather_lanes_plain,
        permute_lanes,
    )
    from animnerf_tpu_torch.ops.warp_blend import (
        warp_blend_fwd,
        warp_blend_fwd_plain,
    )

    dev = ctx.verts.device
    g = torch.Generator(device=dev).manual_seed(0)
    reps, preps = 20, 3  # timed runs of each kernel / plain version
    lines = {}

    # -- kNN: points around the posed V=6890 rig
    N = 1 << 20
    verts = ctx.verts_morton                                  # (1, V, 3)
    V = verts.shape[1]
    pick = torch.randint(0, V, (N,), generator=g, device=dev)
    pts = (verts[0, pick] + 0.05 * torch.randn(N, 3, generator=g,
                                               device=dev))[None]
    d, i = knn_top4(pts, verts)
    dp, ip = knn_top4_plain(pts, verts)
    torch.cuda.synchronize()
    idx_mismatch = int((i != ip).sum())
    err = float((d - dp).abs().max())
    # same key arithmetic (every product and sum rounded, IEEE sqrt) on
    # both sides: indices and distances agree bit for bit
    check(idx_mismatch == 0 and err == 0.0,
          f"knn: {idx_mismatch} index mismatches, max err {err}")
    lines["knn"] = dict(
        shape=f"points (1,{N},3) verts (1,{V},3)", max_abs_err=err,
        tolerance=0.0, idx_mismatch=idx_mismatch,
        ms=time_ms(lambda: knn_top4(pts, verts), reps),
        plain_ms=time_ms(lambda: knn_top4_plain(pts, verts), preps),
        # 3 mul + 4 add in f32 per (point, vertex) pair
        bound_ms=max(7.0 * N * V / PEAK_F32,
                     (N * 12 + V * 12 + N * 32) / PEAK_BYTES) * 1e3,
        bound_by="operations", library_ms=None)

    # -- warp-blend on the same points
    J = ctx.lbs_weights.shape[1]
    rows = torch.nn.functional.pad(pts.transpose(1, 2), (0, 0, 0, 5))
    rows = rows.contiguous()
    table = ctx.table_morton
    args = (rows, d, i, table, J, 0.1, 0.9)
    out = warp_blend_fwd(*args)
    outp = warp_blend_fwd_plain(*args)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, outp))
    tol = 1e-4  # f32 blend; nvcc contracts the blend sums into FMAs
    check(err <= tol, f"warp_blend: max err {err} > {tol}")
    # the kernel reads rows 0..2 of the xyz rows, the distances, the
    # indices and the table (once), and writes out, w and bf
    wb_bytes = (3 * N + 2 * d.numel() + table.numel()
                + sum(t.numel() for t in out)) * 4
    lines["warp_blend"] = dict(
        shape=f"rows (1,8,{N}) knn (1,4,{N}) table {tuple(table.shape)}",
        max_abs_err=err, tolerance=tol,
        ms=time_ms(lambda: warp_blend_fwd(*args), reps),
        plain_ms=time_ms(lambda: warp_blend_fwd_plain(*args), preps),
        bound_ms=max(wb_bytes / PEAK_BYTES,
                     N * (4 * (3 * J + 40) + 100) / PEAK_F32) * 1e3,
        bound_by="bytes", library_ms=None)

    # -- kernel 8, the packed extract-min kNN, at K = 8 (k_neigh 8) and at
    # K = 4, where it must select what kernel 1 selects
    d8, i8 = knn_packed(pts, verts, 8)
    dp8, ip8 = knn_packed_plain(pts, verts, 8)
    torch.cuda.synchronize()
    mism = int((i8 != ip8).sum())
    err = float((d8 - dp8).abs().max())
    check(mism == 0 and err == 0.0,
          f"knn_packed K=8: {mism} index mismatches, max err {err}")
    lines["knn_packed"] = dict(
        shape=f"points (1,{N},3) verts (1,{V},3) K=8", max_abs_err=err,
        tolerance=0.0, idx_mismatch=mism,
        ms=time_ms(lambda: knn_packed(pts, verts, 8), reps),
        plain_ms=time_ms(lambda: knn_packed_plain(pts, verts, 8), preps),
        # kernel 1's operation count: 3 mul + 4 add in f32 per pair
        bound_ms=max(7.0 * N * V / PEAK_F32,
                     (N * 12 + V * 12 + N * 64) / PEAK_BYTES) * 1e3,
        bound_by="operations", library_ms=None)
    d4, i4 = knn_packed(pts, verts, 4)
    torch.cuda.synchronize()
    same = bool(torch.equal(d4, d) and torch.equal(i4, i))
    check(same, "knn_packed K=4 differs from knn_top4")
    lines["knn_packed_k4"] = dict(
        shape=f"points (1,{N},3) verts (1,{V},3) K=4",
        max_abs_err=float((d4 - dp).abs().max()), tolerance=0.0,
        bit_equal_to_knn_top4=same,
        ms=time_ms(lambda: knn_packed(pts, verts, 4), reps),
        plain_ms=time_ms(lambda: knn_packed_plain(pts, verts, 4), preps),
        bound_ms=lines["knn"]["bound_ms"], bound_by="operations",
        library_ms=None)

    # -- warp-blend on the K = 8 neighbours, with one-hot LBS columns so
    # that the confidence gate passes several of them (as rigid_lbs)
    table8 = table.clone()
    table8[..., :J] = torch.nn.functional.one_hot(
        table[..., :J].argmax(-1), J).to(table.dtype)
    args8 = (rows, d8, i8, table8, J, 0.1, 0.9)
    out8 = warp_blend_fwd(*args8)
    outp8 = warp_blend_fwd_plain(*args8)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out8, outp8))
    check(err <= tol, f"warp_blend K=8: max err {err} > {tol}")
    # points that blend more than one neighbour
    multi = float((out8[1][:, 1:] > 0).any(dim=1).float().mean())
    check(multi > 0.1, f"warp_blend K=8: only {multi} of the points blend "
          "more than one neighbour")
    wb8_bytes = (3 * N + 2 * d8.numel() + table.numel()
                 + sum(t.numel() for t in out8)) * 4
    lines["warp_blend_k8"] = dict(
        shape=f"rows (1,8,{N}) knn (1,8,{N}) table {tuple(table.shape)} "
        "one-hot LBS", max_abs_err=err, tolerance=tol,
        share_blending_2_or_more=multi,
        ms=time_ms(lambda: warp_blend_fwd(*args8), reps),
        plain_ms=time_ms(lambda: warp_blend_fwd_plain(*args8), preps),
        bound_ms=max(wb8_bytes / PEAK_BYTES,
                     N * (8 * (3 * J + 40) + 100) / PEAK_F32) * 1e3,
        bound_by="bytes", library_ms=None)
    del d8, i8, dp8, ip8, table8, out8, outp8

    # -- fused MLP: canonical points with the scale512 weights, bf16
    M = 1 << 21
    tv = ctx.verts_template[0]
    pick = torch.randint(0, tv.shape[0], (M,), generator=g, device=dev)
    xyz = tv[pick] + 0.05 * torch.randn(M, 3, generator=g, device=dev)
    xrows = torch.nn.functional.pad(xyz.t(), (0, 0, 0, 5))[None].contiguous()
    nerf = system.scene.nerf_fine
    ws, bs = nerf.packed()
    o = fused_nerf_fwd(xrows, ws, bs, 10, "bfloat16")
    op = fused_nerf_fwd_plain(xrows, ws, bs, 10, "bfloat16")
    torch.cuda.synchronize()
    # same bf16 rounding points; tensor-core and cuBLAS accumulation
    # orders differ, which can flip a bf16 rounding between layers
    err_rgb = float((o[0, :3] - op[0, :3]).abs().max())
    sig_excess = float(((o[0, 3] - op[0, 3]).abs()
                        - (3e-2 + 2e-2 * op[0, 3].abs())).max())
    err = max(err_rgb, float((o[0, 3] - op[0, 3]).abs().max()))
    check(err_rgb <= 2e-2 and sig_excess <= 0.0,
          f"fused_mlp bf16: rgb err {err_rgb}, sigma excess {sig_excess}")
    check(bool((o[0, 4:] == 0).all()), "fused_mlp: rows 4..7 must be zero")
    # f32 path on a slice of the points: no rounding, f32 accumulation
    ws32, bs32 = pack_params({k: v.detach() for k, v in
                              nerf.state_dict().items()}, 10, "float32")
    x32 = xrows[..., :65536].contiguous()
    o32 = fused_nerf_fwd(x32, ws32, bs32, 10, "float32")
    op32 = fused_nerf_fwd_plain(x32, ws32, bs32, 10, "float32")
    torch.cuda.synchronize()
    err32 = float(((o32 - op32).abs()
                   / (1.0 + op32.abs())).max())
    check(err32 <= 1e-4, f"fused_mlp f32: rel err {err32}")
    enc = 3 + 6 * 10  # encoding width; xyz_0 and the skip's enc half
    flops = 2.0 * M * (enc * 256 * 2 + 7 * 256 * 256 + 256 * 1 + 256 * 256
                       + 256 * 128 + 128 * 3)
    lines["fused_mlp"] = dict(
        shape=f"rows (1,8,{M}) bf16 weights 13 packed", max_abs_err=err,
        tolerance="rgb 2e-2; sigma 3e-2 + 2e-2*|sigma|", f32_rel_err=err32,
        ms=time_ms(lambda: fused_nerf_fwd(xrows, ws, bs, 10, "bfloat16"), reps),
        plain_ms=time_ms(lambda: fused_nerf_fwd_plain(xrows, ws, bs, 10,
                                                    "bfloat16"), preps),
        bound_ms=max(flops / PEAK_BF16,
                     (M * (12 + 32) + sum(w.numel() * 2 for w in ws))
                     / PEAK_BYTES) * 1e3,
        bound_by="operations", library_ms=None)

    # -- lane permute: the fine merge-sort payload, C=5, R=65536
    R = 65536
    pay = torch.randn(1, 5, R, 128, generator=g, device=dev)
    order = torch.argsort(torch.rand(1, R, 128, generator=g, device=dev),
                          dim=-1).to(torch.int32)
    sp = permute_lanes(pay, order)
    spp = gather_lanes_plain(pay, order)
    torch.cuda.synchronize()
    err = float((sp - spp).abs().max())
    check(err == 0.0, f"permute_lanes: max err {err} (a copy must be exact)")
    idx64 = order.long()[:, None].expand(1, 5, R, 128)
    lines["permute_lanes"] = dict(
        shape=f"payload (1,5,{R},128) order (1,{R},128)", max_abs_err=err,
        tolerance=0.0,
        ms=time_ms(lambda: permute_lanes(pay, order), reps),
        plain_ms=time_ms(lambda: gather_lanes_plain(pay, order), preps),
        bound_ms=(2 * pay.numel() + order.numel()) * 4 / PEAK_BYTES * 1e3,
        bound_by="bytes",
        library_ms=time_ms(lambda: torch.gather(pay, 3, idx64), reps))
    return lines


def kernel_lines_train(dev):
    """Check and time the training step's kernels at its shapes: the kNN
    with the tile skip on Morton-ordered points of 16 frames (32,768
    coarse survivors each, as a 16 x 1024-ray step keeps), the weighted
    scatter of those neighbours, and the MLP backward over 2^20 points
    (the fine MLP's coarse survivors + fine samples) in bf16, and over
    2^16 points in f32."""
    import torch

    from animnerf_tpu_torch.data.synthetic import (
        make_body_model,
        random_pose_params,
    )
    from animnerf_tpu_torch.models.nerf import NeRFMLP
    from animnerf_tpu_torch.models.warp import prepare_frame
    from animnerf_tpu_torch.ops.blend import (
        weighted_scatter_rows,
        weighted_scatter_rows_plain,
    )
    from animnerf_tpu_torch.ops.fused_mlp import (
        fused_nerf_bwd,
        fused_nerf_bwd_plain,
        pack_params,
    )
    from animnerf_tpu_torch.ops.knn_kernel import (
        knn_packed,
        knn_top4,
        knn_top4_plain,
    )
    from animnerf_tpu_torch.ops.perm_sort import _morton_rows

    g = torch.Generator(device=dev).manual_seed(1)
    reps, preps = 20, 3
    lines = {}

    # -- kNN with the tile skip: 16 posed frames, Morton-ordered points
    B, N = 16, 32768
    bm = make_body_model(6890, 24, seed=0).to(dev)
    pose = random_pose_params(24, batch=B, seed=4)
    tmpl = random_pose_params(24, batch=B, seed=2)
    tmpl["transl"] = np.zeros_like(tmpl["transl"])
    with torch.no_grad():
        ctx = prepare_frame(bm, {k: torch.tensor(v, device=dev)
                                 for k, v in pose.items()},
                            {k: torch.tensor(v, device=dev)
                             for k, v in tmpl.items()})
    verts = ctx.verts_morton.contiguous()                    # (16, V, 3)
    V = verts.shape[1]
    pick = torch.randint(0, V, (B, N), generator=g, device=dev)
    pts = torch.gather(verts, 1, pick[..., None].expand(B, N, 3)) \
        + 0.1 * torch.randn(B, N, 3, generator=g, device=dev)
    order = torch.argsort(_morton_rows(pts[..., 0], pts[..., 1],
                                       pts[..., 2]), dim=1, stable=True)
    pts = torch.gather(pts, 1, order[..., None].expand(B, N, 3)).contiguous()
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    d1, i1 = knn_top4(pts, verts, tile_skip=True, stats=stats)
    d0, i0 = knn_top4(pts, verts)
    dp, ip = knn_top4_plain(pts, verts)
    torch.cuda.synchronize()
    swept, skipped = (int(v) for v in stats.tolist())
    bit_equal = bool(torch.equal(d0, d1) and torch.equal(i0, i1))
    err = float((d1 - dp).abs().max())
    mism = int((i1 != ip).sum())
    check(bit_equal, "knn tile_skip: output differs from tile_skip=False")
    check(mism == 0 and err == 0.0,
          f"knn tile_skip: {mism} index mismatches, max err {err}")
    swept_share = swept / max(swept + skipped, 1)
    lines["knn_tile_skip"] = dict(
        shape=f"points ({B},{N},3) Morton-ordered verts ({B},{V},3)",
        max_abs_err=err, tolerance=0.0, bit_equal_to_no_skip=bit_equal,
        warp_tiles_swept=swept, warp_tiles_skipped=skipped,
        skipped_share=1.0 - swept_share,
        ms=time_ms(lambda: knn_top4(pts, verts, tile_skip=True), reps),
        ms_no_skip=time_ms(lambda: knn_top4(pts, verts), reps),
        plain_ms=time_ms(lambda: knn_top4_plain(pts, verts), preps),
        # the pairs this run's skip left to sweep, 7 f32 ops each
        bound_ms=max(7.0 * B * N * V * swept_share / PEAK_F32,
                     B * (N * 12 + V * 12 + N * 32) / PEAK_BYTES) * 1e3,
        bound_by="operations", library_ms=None)

    # -- weighted scatter of those neighbours (the warp-blend backward)
    w = torch.rand(B, 4, N, generator=g, device=dev)
    w = (w / w.sum(1, keepdim=True)).contiguous()
    gr = torch.randn(B, 16, N, generator=g, device=dev)
    gr[:, 12:] = 0.0  # the warp-blend cotangent's zero rows
    out = weighted_scatter_rows(i1, w, gr, V)
    out2 = weighted_scatter_rows(i1, w, gr, V)
    outp = weighted_scatter_rows_plain(i1, w, gr, V)
    torch.cuda.synchronize()
    err = float((out - outp).abs().max())
    # both versions sum each row in the stable sort order of its entries
    # (err 0 expected); the bound is a few ulps of the largest row sum
    tol = 1e-5 * float(outp.abs().max())
    deterministic = bool(torch.equal(out, out2))
    check(err <= tol, f"scatter: max err {err} > {tol}")
    check(deterministic, "scatter: two runs differ")
    contrib = (w[:, :, None, :] * gr[:, None]).permute(0, 1, 3, 2) \
        .reshape(-1, 16).contiguous()
    rows = (i1.long() + (torch.arange(B, device=dev) * V)[:, None, None]
            ).reshape(-1)
    flat = torch.zeros(B * V, 16, device=dev)
    lines["scatter"] = dict(
        shape=f"idx/w ({B},4,{N}) g ({B},16,{N}) -> ({B},{V},16)",
        max_abs_err=err, tolerance=tol, deterministic=deterministic,
        bit_equal_to_plain=bool(torch.equal(out, outp)),
        # the wrapper's stable sort of the keys included
        ms=time_ms(lambda: weighted_scatter_rows(i1, w, gr, V), reps),
        plain_ms=time_ms(lambda: weighted_scatter_rows_plain(i1, w, gr, V),
                         preps),
        # idx, w and g read once, the table written once
        bound_ms=B * (N * (4 + 4 + 16) * 4 + V * 16 * 4) / PEAK_BYTES * 1e3,
        bound_by="bytes",
        library_ms=time_ms(lambda: flat.zero_().index_add_(0, rows, contrib),
                           reps))

    # -- the same scatter at K = 8, on the packed kNN's 8 neighbours
    _, i8 = knn_packed(pts, verts, 8)
    w8 = torch.rand(B, 8, N, generator=g, device=dev)
    w8 = (w8 / w8.sum(1, keepdim=True)).contiguous()
    out = weighted_scatter_rows(i8, w8, gr, V)
    out2 = weighted_scatter_rows(i8, w8, gr, V)
    outp = weighted_scatter_rows_plain(i8, w8, gr, V)
    torch.cuda.synchronize()
    err = float((out - outp).abs().max())
    tol = 1e-5 * float(outp.abs().max())
    deterministic = bool(torch.equal(out, out2))
    check(err <= tol, f"scatter K=8: max err {err} > {tol}")
    check(deterministic, "scatter K=8: two runs differ")
    contrib8 = (w8[:, :, None, :] * gr[:, None]).permute(0, 1, 3, 2) \
        .reshape(-1, 16).contiguous()
    rows8 = (i8.long() + (torch.arange(B, device=dev) * V)[:, None, None]
             ).reshape(-1)
    lines["scatter_k8"] = dict(
        shape=f"idx/w ({B},8,{N}) g ({B},16,{N}) -> ({B},{V},16)",
        max_abs_err=err, tolerance=tol, deterministic=deterministic,
        bit_equal_to_plain=bool(torch.equal(out, outp)),
        ms=time_ms(lambda: weighted_scatter_rows(i8, w8, gr, V), reps),
        plain_ms=time_ms(lambda: weighted_scatter_rows_plain(i8, w8, gr, V),
                         preps),
        bound_ms=B * (N * (8 + 8 + 16) * 4 + V * 16 * 4) / PEAK_BYTES * 1e3,
        bound_by="bytes",
        library_ms=time_ms(lambda: flat.zero_().index_add_(0, rows8,
                                                           contrib8), reps))
    del i8, w8, contrib8, rows8, out2

    # -- fused MLP backward: bf16 over 2^20 points, f32 over 2^16
    torch.manual_seed(0)
    mlp = NeRFMLP(10, "float32").to(dev)
    state = {k: v.detach() for k, v in mlp.state_dict().items()}
    enc = 3 + 6 * 10
    fwd_flops = 2.0 * (enc * 256 * 2 + 7 * 256 * 256 + 256 * 1 + 256 * 256
                       + 256 * 128 + 128 * 3)
    # Tolerances. A ReLU pre-activation within a rounding of 0 can take
    # the other side of the mask in the two versions (f32: one point in
    # ~10^4 here); its d_xyz then differs outright and its term moves the
    # weight-gradient sums, which cancel to ~1/sqrt(M) of their terms.
    # So: per-point d_xyz relative error, median and the share above
    # 1e-3, and rel-L2 of every gradient. bf16: besides, tensor-core and
    # cuBLAS sum orders flip bf16 roundings of the cotangents.
    for dt, M, peak, tol in (
            ("bfloat16", 1 << 20, PEAK_BF16,
             dict(median_point=2e-2, flip_share=0.5, rel_l2=2e-2)),
            ("float32", 1 << 16, PEAK_F32,
             dict(median_point=1e-5, flip_share=1e-3, rel_l2=1e-2))):
        ws, bs = pack_params(state, 10, dt)
        xyz = torch.zeros(1, 8, M, device=dev)
        xyz[0, :3] = 0.3 * torch.randn(3, M, generator=g, device=dev)
        dout = torch.zeros(1, 8, M, device=dev)
        dout[0, :4] = 1e-3 * torch.randn(4, M, generator=g, device=dev)
        a = fused_nerf_bwd(xyz, ws, bs, dout, 10, dt)
        a2 = fused_nerf_bwd(xyz, ws, bs, dout, 10, dt)
        b = fused_nerf_bwd_plain(xyz, ws, bs, dout, 10, dt)
        torch.cuda.synchronize()
        outs = (a[0],) + a[1] + a[2]
        deterministic = all(torch.equal(x, y) for x, y in
                            zip(outs, (a2[0],) + a2[1] + a2[2]))
        rel = [float((x - y).norm() / max(float(y.norm()), 1e-30))
               for x, y in zip(outs, (b[0],) + b[1] + b[2])]
        err = max(float((x - y).abs().max())
                  for x, y in zip(outs, (b[0],) + b[1] + b[2]))
        pt = ((a[0][0, :3] - b[0][0, :3]).norm(dim=0)
              / (b[0][0, :3].norm(dim=0) + 1e-12))
        median_point = float(pt.median())
        flip_share = float((pt > 1e-3).float().mean())
        check(deterministic, f"fused_mlp_bwd {dt}: two runs differ")
        check(median_point <= tol["median_point"]
              and flip_share <= tol["flip_share"]
              and max(rel) <= tol["rel_l2"],
              f"fused_mlp_bwd {dt}: median point {median_point}, flip "
              f"share {flip_share}, rel-L2 {max(rel)}")
        name = "fused_mlp_bwd" if dt == "bfloat16" else "fused_mlp_bwd_f32"
        split = {}
        if dt == "bfloat16":
            # device time of the main kernel (recompute + dgrad) and of the
            # rest (weight gradients, head and bias sums, split reduction)
            # in one profiled call; the main kernel's own bound: its
            # products (2x the forward's flops) or the H and G scratch it
            # writes (9,856 B a point), the larger
            split = split_bwd_profile(
                lambda: fused_nerf_bwd(xyz, ws, bs, dout, 10, dt))
            split.update(
                bound_main_ms=max(2.0 * fwd_flops * M / peak,
                                  M * 9856 / PEAK_BYTES) * 1e3,
                prev_ms=PREV_BWD_MS)
        lines[name] = dict(
            shape=f"rows (1,8,{M}) dout (1,8,{M}) {dt} weights 13 packed",
            max_abs_err=err, max_rel_l2=max(rel),
            median_point_rel=median_point, point_share_above_1e3=flip_share,
            tolerance=tol, deterministic=deterministic,
            ms=time_ms(lambda: fused_nerf_bwd(xyz, ws, bs, dout, 10, dt),
                       5 if dt == "bfloat16" else reps),
            plain_ms=time_ms(lambda: fused_nerf_bwd_plain(
                xyz, ws, bs, dout, 10, dt), preps, warmup=1),
            # recomputed forward + dgrad + wgrad: 3x the forward's flops
            bound_ms=max(3.0 * fwd_flops * M / peak,
                         M * (12 + 16 + 12) / PEAK_BYTES) * 1e3,
            bound_by="operations", library_ms=None, **split)
        del a, a2, b
    return lines


SMPLX_KNN_POINTS = 1 << 20
SMPLX_MIN_DIST_POINTS = 1 << 22


def kernel_lines_smplx(dev):
    """Check and time the SMPL-X kernels at their main-path widths against
    the posed seed-0 SMPL-X cloud (V=10475, Morton order as the warp sees
    it): the exact kNN over 2^20 points and the nearest-vertex distance
    over 2^22 points (a slab of the serving pre-pass), and the exact kNN
    at K = 8. Both versions round every operation alike, follow the same
    top-k rule and take IEEE square roots, so the outputs must be
    bit-equal. Neither has a one-call PyTorch counterpart (cdist then
    topk / amin is two calls), so library_ms is null."""
    import torch

    from animnerf_tpu_torch.models.warp import prepare_frame
    from animnerf_tpu_torch.ops.knn import (
        min_vertex_distance,
        min_vertex_distance_plain,
    )
    from animnerf_tpu_torch.ops.knn_kernel import knn_exact, knn_exact_plain

    g = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():
        ctx = prepare_frame(smplx_rig().to(dev),
                            tensors(smplx_params(1, 1), dev),
                            tensors(smplx_params(1, 2, zero_transl=True), dev))
    verts = ctx.verts_morton.contiguous()
    V = verts.shape[1]

    def points(N):
        pick = torch.randint(0, V, (N,), generator=g, device=dev)
        return (verts[0, pick] + 0.1 * torch.randn(N, 3, generator=g,
                                                   device=dev))[None]

    lines = {}
    N = SMPLX_KNN_POINTS
    pts = points(N).contiguous()
    for k, name in ((4, "knn_exact"), (8, "knn_exact_k8")):
        d, i = knn_exact(pts, verts, k)
        dp, ip = knn_exact_plain(pts, verts, k, max_elems=PLAIN_MAX_ELEMS)
        torch.cuda.synchronize()
        mism = int((i != ip).sum())
        err = float((d - dp).abs().max())
        check(mism == 0 and torch.equal(d, dp),
              f"{name}: {mism} index mismatches, max err {err}")
        lines[name] = dict(
            shape=f"points (1,{N},3) verts (1,{V},3) K={k}",
            max_abs_err=err, tolerance=0.0, idx_mismatch=mism,
            ms=time_ms(lambda: knn_exact(pts, verts, k), 20),
            plain_ms=time_ms(lambda: knn_exact_plain(
                pts, verts, k, max_elems=PLAIN_MAX_ELEMS), 1, warmup=0),
            # 3 sub, 3 mul, 2 add and a compare per pair, none an FMA
            bound_ms=max(9.0 * N * V / PEAK_F32_NONFMA,
                         (N * 12 + V * 12 + N * 8 * k) / PEAK_BYTES) * 1e3,
            bound_by="operations", library_ms=None)

    N = SMPLX_MIN_DIST_POINTS
    pts = points(N).contiguous()
    m = min_vertex_distance(pts, verts)
    mp = min_vertex_distance_plain(pts, verts)
    torch.cuda.synchronize()
    err = float((m - mp).abs().max())
    check(torch.equal(m, mp), f"min_dist: max err {err}")
    lines["min_dist"] = dict(
        shape=f"points (1,{N},3) verts (1,{V},3)", max_abs_err=err,
        tolerance=0.0,
        ms=time_ms(lambda: min_vertex_distance(pts, verts), 10),
        plain_ms=time_ms(lambda: min_vertex_distance_plain(pts, verts), 1,
                         warmup=1),
        # 3 sub, 3 mul, 2 add and a min per pair, none an FMA
        bound_ms=max(9.0 * N * V / PEAK_F32_NONFMA,
                     (N * 12 + V * 12 + N * 4) / PEAK_BYTES) * 1e3,
        bound_by="operations", library_ms=None)
    return lines


def kernel_lines_mxu(dev):
    """Check and time the matmul-form kNN at the kNN tool's shapes (16 x
    65536 ray-like points, V=6890, the tool's first point set) in both
    precisions. The kernel and the plain version round every product and
    sum alike, so the outputs must be bit-equal. A batched matmul computes
    d2 but not the top-4, so library_ms is null."""
    import torch

    from animnerf_tpu_torch.ops.knn_mxu import knn_mxu, knn_mxu_plain
    from animnerf_tpu_torch.tools.bench_knn import make_inputs

    verts, sets = make_inputs(16, 65536)
    verts = torch.from_numpy(verts).to(dev)
    pts = torch.from_numpy(sets[0]).to(dev)
    B, N, _ = pts.shape
    V = verts.shape[1]
    lines = {}
    for prec, name in (("highest", "knn_mxu"), ("default", "knn_mxu_default")):
        d, i = knn_mxu(pts, verts, 4, prec)
        dp, ip = knn_mxu_plain(pts, verts, 4, prec,
                               max_elems=PLAIN_MAX_ELEMS)
        torch.cuda.synchronize()
        mism = int((i != ip).sum())
        err = float((d - dp).abs().max())
        check(mism == 0 and err == 0.0,
              f"{name}: {mism} index mismatches, max err {err}")
        lines[name] = dict(
            shape=f"points ({B},{N},3) verts ({B},{V},3) precision {prec}",
            max_abs_err=err, tolerance=0.0, idx_mismatch=mism,
            ms=time_ms(lambda: knn_mxu(pts, verts, 4, prec), 10),
            plain_ms=time_ms(lambda: knn_mxu_plain(
                pts, verts, 4, prec, max_elems=PLAIN_MAX_ELEMS), 1, warmup=0),
            # 8 multiply-adds (16 flops) per pair at the FMA peak, above
            # one compare per pair at the non-FMA rate
            bound_ms=max(16.0 * B * N * V / PEAK_F32,
                         1.0 * B * N * V / PEAK_F32_NONFMA,
                         B * (N * 32 + V * 32 + N * 32) / PEAK_BYTES) * 1e3,
            bound_by="operations", library_ms=None)
    return lines


def bench_knn_phase():
    """The port's kNN tool on the card, launch counts reset just before and
    read just after: every row of the JAX tool, extract-min and tournament
    bit-equal, the matmul form at "highest" within 1e-4 of the exact
    kNN's distances."""
    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.tools import bench_knn

    _build.reset_launches()
    rows = bench_knn.run("cuda")
    launches = dict(_build.LAUNCHES)
    names = [r["row"] for r in rows if "row" in r]
    check(names == ["exact kNN", "min distance", "packed extract-min",
                    "packed tournament", "mxu highest", "mxu default"],
          f"bench_knn rows: {names}")
    checks = {r["check"]: r for r in rows if "check" in r}
    bit = checks["tournament vs extract-min bit-equal"]
    check(bit["d"] and bit["i"], f"bench_knn: {bit}")
    check(checks["mxu highest vs exact"]["max_abs_d_err"] < 1e-4,
          f"bench_knn: {checks['mxu highest vs exact']}")
    check(all(launches[k] > 0 for k in ("knn_exact", "min_dist",
                                        "knn_packed", "knn", "knn_mxu")),
          f"bench_knn launched too few kernels: {launches}")
    return rows, launches


def tensors(d: dict, device) -> dict:
    import torch

    return {k: torch.tensor(v, device=device) for k, v in d.items()}


KERNELS = {
    "knn": ("animnerf_tpu_torch/csrc/knn.cu",
            "animnerf_tpu/ops/knn_pallas.py:268"),
    "knn_tile_skip": ("animnerf_tpu_torch/csrc/knn.cu",
                      "animnerf_tpu/ops/knn_pallas.py:268"),
    "warp_blend": ("animnerf_tpu_torch/csrc/warp_blend.cu",
                   "animnerf_tpu/ops/warp_blend.py:48"),
    "scatter": ("animnerf_tpu_torch/csrc/scatter.cu",
                "animnerf_tpu/ops/blend.py:59"),
    "fused_mlp": ("animnerf_tpu_torch/csrc/fused_mlp.cu",
                  "animnerf_tpu/ops/fused_mlp.py:182"),
    "fused_mlp_bwd": ("animnerf_tpu_torch/csrc/fused_mlp_bwd.cu",
                      "animnerf_tpu/ops/fused_mlp.py:227"),
    "permute_lanes": ("animnerf_tpu_torch/csrc/sort_lanes.cu",
                      "animnerf_tpu/ops/sort_lanes.py:29"),
    "knn_exact": ("animnerf_tpu_torch/csrc/knn_exact.cu",
                  "animnerf_tpu/ops/knn_pallas.py:35"),
    "min_dist": ("animnerf_tpu_torch/csrc/min_dist.cu",
                 "animnerf_tpu/ops/knn_pallas.py:456"),
    "knn_packed": ("animnerf_tpu_torch/csrc/knn_packed.cu",
                   "animnerf_tpu/ops/knn_pallas.py:161"),
    "knn_packed_k4": ("animnerf_tpu_torch/csrc/knn_packed.cu",
                      "animnerf_tpu/ops/knn_pallas.py:161"),
    "knn_exact_k8": ("animnerf_tpu_torch/csrc/knn_exact.cu",
                     "animnerf_tpu/ops/knn_pallas.py:35"),
    "warp_blend_k8": ("animnerf_tpu_torch/csrc/warp_blend.cu",
                      "animnerf_tpu/ops/warp_blend.py:48"),
    "scatter_k8": ("animnerf_tpu_torch/csrc/scatter.cu",
                   "animnerf_tpu/ops/blend.py:59"),
    "knn_mxu": ("animnerf_tpu_torch/csrc/knn_mxu.cu",
                "tools/bench_knn.py:29"),
    "knn_mxu_default": ("animnerf_tpu_torch/csrc/knn_mxu.cu",
                        "tools/bench_knn.py:29"),
}
SERVE_KERNELS = ("knn", "warp_blend", "fused_mlp", "permute_lanes")
K8_SERVE_KERNELS = ("knn_packed", "warp_blend", "fused_mlp", "permute_lanes")
K8_TRAIN_KERNELS = ("knn_packed", "warp_blend", "scatter", "fused_mlp",
                    "fused_mlp_bwd", "permute_lanes")
TRAIN_KERNELS = ("knn", "knn_tile_skip", "warp_blend", "scatter",
                 "fused_mlp", "fused_mlp_bwd", "permute_lanes")
SMPLX_SERVE_KERNELS = ("min_dist", "knn_exact", "warp_blend", "fused_mlp",
                       "permute_lanes")
SMPLX_TRAIN_KERNELS = ("knn_exact", "warp_blend", "scatter", "fused_mlp",
                       "fused_mlp_bwd", "permute_lanes")


# ------------------------------------------------------------------ slice


def render_turntable(system, bp, tmpl, angles, H=512, W=512,
                     prepass="boxes", min_body_px=500, profile=True):
    """Warm-up view, then the views of ``angles`` with the launch counts
    reset just before and read just after, then (``profile``) one more
    view under torch.profiler. Returns (views, launches, profile, images)."""
    import torch

    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.render.inference import (
        Renderer,
        turntable_rotation,
    )

    renderer = Renderer(system, prepass=prepass)
    rays = frame_rays(H, W)

    def frames(views):
        return [dict(body_params=bp, body_tmpl=tmpl, rays=rays,
                     P=turntable_rotation(i, 64), img_wh=(W, H))
                for i in views]

    for _ in renderer.render_stream(frames(angles[:1])):  # warm-up view
        pass
    torch.cuda.synchronize()
    _build.reset_launches()
    views, images = [], []
    t0 = time.perf_counter()
    for k, (img, mask, depth) in enumerate(
            renderer.render_stream(frames(angles))):
        t1 = time.perf_counter()  # outputs are on the host: device done
        n_c, n_f = renderer.last_counts
        finite = bool(np.isfinite(img).all() and np.isfinite(mask).all()
                      and np.isfinite(depth).all())
        views.append(dict(view=angles[k], ms=(t1 - t0) * 1e3, n_coarse=n_c,
                          n_fine=n_f, body_px=int((mask > 0.5).sum()),
                          rgb_mean=float(img.mean()),
                          mask_mean=float(mask.mean()),
                          depth_min=float(depth.min()), finite=finite))
        images.append(img)
        check(finite, f"view {angles[k]}: non-finite output")
        check(views[-1]["body_px"] > min_body_px and n_c > 0 and n_f > 0,
              f"view {angles[k]}: body not visible ({views[-1]})")
        t0 = time.perf_counter()
    launches = dict(_build.LAUNCHES)

    def one_view():
        for _ in renderer.render_stream(frames(angles[:1])):
            pass

    prof = profile_call(one_view, "view") if profile else None
    return views, launches, prof, images


def profile_call(fn, what: str):
    """Device time by kernel over one more call of fn (torch.profiler);
    the launch counts of the main path were read before this."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    # device-side events only: the aten ops that launched them carry the
    # same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    split = bwd_split(events)
    return {f"{what}_ms_profiled": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "mlp_bwd_main_ms": split["main_ms"],
            "mlp_bwd_wgrad_ms": split["wgrad_ms"],
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in events[:15]]}


def bwd_split(events) -> dict:
    """Device ms of the MLP backward's main kernel and of its other
    kernels (weight gradients, head and bias sums, split reduction) among
    profiler events."""
    main = sum(e.self_device_time_total for e in events
               if "mlp_bwd_main" in e.key) / 1e3
    rest = sum(e.self_device_time_total for e in events
               if any(k in e.key for k in ("wgrad", "bias_sums",
                                           "reduce_splits"))) / 1e3
    return {"main_ms": main, "wgrad_ms": rest}


def split_bwd_profile(fn) -> dict:
    """bwd_split over one profiled call of fn (after a warm-up)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return bwd_split([e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA])


def slice_parity(ck, bp, tmpl, H=96, W=96, rigid=False, bounds=PARITY_BOUNDS,
                 psnr_only=False, **cfg):
    """One view on the card (kernels) and on the CPU (plain versions), the
    scale512 system (``rigid`` and ``cfg`` as in scale512_system), per
    (compute dtype, (max abs, PSNR bound)) of ``bounds``. ``psnr_only``
    checks the PSNR bound alone and counts the image values beyond the
    max-abs bound (for the rigid rig, whose warp jumps where a point's
    nearest vertex changes bone: last-bit geometry differences between
    the card and the CPU can move a sample across such a jump)."""
    from animnerf_tpu_torch.render.inference import (
        Renderer,
        turntable_rotation,
    )

    rays = frame_rays(H, W)
    P = turntable_rotation(17, 64)
    out = {}
    for dtype, bound in bounds:
        gpu = scale512_system(ck, "cuda", rigid, compute_dtype=dtype, **cfg)
        cpu = scale512_system(ck, "cpu", rigid, compute_dtype=dtype, **cfg)
        rg = Renderer(gpu)
        rc = Renderer(cpu, device="cpu")
        ig, mg, dg = rg.render_frame(bp, tmpl, rays, P, (W, H))
        ic, mc, dc = rc.render_frame(bp, tmpl, rays, P, (W, H))
        mse = float(np.mean((ig - ic) ** 2))
        psnr = 10 * math.log10(1.0 / max(mse, 1e-20))
        err = float(np.abs(ig - ic).max())
        out[dtype] = dict(max_abs_img=err, max_abs_mask=float(
            np.abs(mg - mc).max()), psnr_db=psnr, bound_max_abs=bound[0],
            bound_psnr_db=bound[1], counts_gpu=rg.last_counts,
            counts_cpu=rc.last_counts,
            values_over_max_abs=int((np.abs(ig - ic) > bound[0]).sum()),
            of=int(ig.size))
        check((psnr_only or err <= bound[0]) and psnr >= bound[1],
              f"slice parity {dtype}: max abs {err}, PSNR {psnr}")
    return out


def opaque_shell(system) -> None:
    """Raise both sigma heads' biases by 30 so that random weights give an
    opaque 0.2 m shell around the body: the views then show the body, and
    the parity checks compare silhouettes and fine samples, not an almost
    empty frame."""
    import torch

    with torch.no_grad():
        for net in (system.scene.nerf, system.scene.nerf_fine):
            net.sigma.bias += 30.0


def smplx_serve(angles):
    """The SMPL-X turntable with the exact pre-pass (launches, profile),
    then the same views with the box pre-pass: the two images agree."""
    from animnerf_tpu_torch.system import AnimNeRFSystem

    system = AnimNeRFSystem(SMPLX_CFG, smplx_rig(), device="cuda", seed=0)
    opaque_shell(system)
    bp, tmpl = smplx_params(1, 1), smplx_params(1, 2, zero_transl=True)
    views, launches, prof, imgs = render_turntable(
        system, bp, tmpl, angles, prepass="exact")
    check(all(launches[k] > 0 for k in SMPLX_SERVE_KERNELS)
          and launches["knn"] == launches["knn_packed"] == 0,
          f"SMPL-X serving launched the wrong kernels: {launches}")
    bviews, _, _, bimgs = render_turntable(system, bp, tmpl, angles,
                                           prepass="boxes", profile=False)
    # both pre-passes are exact end to end: a kept sample that is not
    # valid gets the outside-shell sigma, and every kernel works per point
    agree = max(float(np.abs(a - b).max()) for a, b in zip(imgs, bimgs))
    check(agree <= 1e-5, f"exact vs boxes pre-pass images: {agree}")
    return views, launches, prof, bviews, agree


def smplx_serve_parity(H=64, W=64, cfg=None, bounds=PARITY_BOUNDS):
    """One SMPL-X view with prepass="exact" on the card (kernels) and on
    the CPU (plain versions), per (compute dtype, (max abs, PSNR bound)) of
    ``bounds``, those of slice_parity; ``cfg`` replaces SMPLX_CFG."""
    from animnerf_tpu_torch.render.inference import (
        Renderer,
        turntable_rotation,
    )
    from animnerf_tpu_torch.system import AnimNeRFSystem

    rays = frame_rays(H, W)
    P = turntable_rotation(17, 64)
    bp, tmpl = smplx_params(1, 1), smplx_params(1, 2, zero_transl=True)
    out = {}
    for dtype, bound in bounds:
        cfg_d = dict(cfg or SMPLX_CFG, compute_dtype=dtype)
        res = {}
        for dv in ("cuda", "cpu"):
            system = AnimNeRFSystem(cfg_d, smplx_rig(), device=dv, seed=0)
            opaque_shell(system)
            r = Renderer(system, device=dv, prepass="exact")
            t0 = time.perf_counter()
            img, mask, _ = r.render_frame(bp, tmpl, rays, P, (W, H))
            res[dv] = (img, mask, r.last_counts, time.perf_counter() - t0)
        (ig, mg, cg, _), (ic, mc, cc, sc) = res["cuda"], res["cpu"]
        mse = float(np.mean((ig - ic) ** 2))
        psnr = 10 * math.log10(1.0 / max(mse, 1e-20))
        err = float(np.abs(ig - ic).max())
        out[dtype] = dict(max_abs_img=err, max_abs_mask=float(
            np.abs(mg - mc).max()), psnr_db=psnr, bound_max_abs=bound[0],
            bound_psnr_db=bound[1], counts_gpu=cg, counts_cpu=cc,
            body_px=int((mc > 0.5).sum()), cpu_seconds=sc)
        check(err <= bound[0] and psnr >= bound[1],
              f"SMPL-X parity {dtype}: max abs {err}, PSNR {psnr}")
        check(out[dtype]["body_px"] > 50, f"SMPL-X parity: no body {out}")
    return out


# ------------------------------------------------------------------ train

# the flagship of __graft_entry__._flagship_system / bench.py, in the
# reference's config keys (frames 1..8 give num_frames 8)
FLAGSHIP_CFG = {"n_samples": 64, "n_importance": 32, "use_view": False,
                "freqs_xyz": 10, "num_frames": 8, "gender": "neutral",
                "compute_dtype": "bfloat16"}
# the same field on an SMPL-X body (body_pose 63 wide, hands, jaw,
# expression)
SMPLX_CFG = dict(FLAGSHIP_CFG, model_type="smplx")
# the flagship with 8 neighbours per warped point
K8_CFG = dict(FLAGSHIP_CFG, k_neigh=8)


def smpl_rig():
    from animnerf_tpu_torch.data.synthetic import make_body_model

    return make_body_model(6890, 24, seed=0)


def rigid_smpl_rig():
    return rigid_lbs(smpl_rig())


def smplx_rig():
    """The seed-0 SMPL-X rig: V=10475, J=55, 6 hand PCA components."""
    from animnerf_tpu_torch.data.synthetic import make_body_model

    return make_body_model(10475, model_type="smplx", seed=0)


def smplx_params(B: int, seed: int, zero_transl: bool = False) -> dict:
    """Every SMPL-X body parameter (models/body_params.py::PARAM_DIMS),
    numpy float32 from a seed."""
    from animnerf_tpu_torch.models.body_params import PARAM_DIMS

    rng = np.random.default_rng(seed)
    p = {k: rng.normal(scale=0.5 if k in ("betas", "transl", "expression")
                       else 0.3, size=(B, d)).astype(np.float32)
         for k, d in PARAM_DIMS["smplx"].items()}
    if zero_transl:
        p["transl"][:] = 0.0
    return p


def train_rays(batch: int, n_rays: int, seed: int = 0) -> np.ndarray:
    """bench.py's rays: origins around (0, 0, 3) looking at the body."""
    rng = np.random.default_rng(seed)
    o = rng.normal(scale=0.1, size=(batch, n_rays, 3)).astype(np.float32)
    o[..., 2] += 3.0
    d = -o + rng.normal(scale=0.05, size=o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near = np.full((batch, n_rays, 1), 0.1, np.float32)
    far = np.full((batch, n_rays, 1), 10.0, np.float32)
    return np.concatenate([o, d, near, far], axis=-1)


def train_batches(B: int, n_rays: int, seeds, device,
                  model_type: str = "smpl"):
    """bench.py's batch (random targets and fg/bg points from seed 0,
    seed-2 template poses with zero transl, every SMPL-X parameter for an
    SMPL-X rig), one per ray seed."""
    import torch

    from animnerf_tpu_torch.data.synthetic import random_pose_params

    rng = np.random.default_rng(0)
    if model_type == "smplx":
        tmpl = smplx_params(B, 2, zero_transl=True)
    else:
        tmpl = random_pose_params(24, batch=B, seed=2)
        tmpl["transl"] = np.zeros_like(tmpl["transl"])
    base = {
        "frame_idx": np.arange(B, dtype=np.int64) % FLAGSHIP_CFG["num_frames"],
        "rgbs": rng.uniform(size=(B, n_rays, 3)).astype(np.float32),
        "alphas": rng.uniform(size=(B, n_rays, 1)).astype(np.float32),
        "fg_points": rng.normal(scale=0.2, size=(B, 128, 3)).astype(np.float32),
        "bg_points": rng.normal(scale=0.8, size=(B, 128, 3)).astype(np.float32),
        **{k + "_template": v for k, v in tmpl.items()},
    }
    return [{k: torch.tensor(v, device=device) for k, v in
             dict(base, rays=train_rays(B, n_rays, seed=s)).items()}
            for s in seeds]


def finite(trainer, details) -> bool:
    import torch

    flags = [torch.isfinite(details["loss"]).all()]
    flags += [torch.isfinite(p.grad).all() for p in
              trainer.system.parameters() if p.grad is not None]
    return bool(torch.stack(flags).all())


def train_phase(dev, cfg=FLAGSHIP_CFG, make_rig=smpl_rig,
                model_type: str = "smpl", n_timed: int = 20,
                n_fixed: int = 30, need=TRAIN_KERNELS, absent=(),
                B: int = 16, R: int = 1024):
    """The bench.py step: warm-up, ``n_timed`` timed steps (launch counts
    reset just before and read just after: every kernel of ``need``
    launched, none of ``absent``), one profiled step, then ``n_fixed``
    steps on one fixed batch."""
    import torch

    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.training.system import RowsCompactTrainer

    system = AnimNeRFSystem(cfg, make_rig(), device=dev, seed=0)
    trainer = RowsCompactTrainer(system, steps_per_epoch=100)
    batches = train_batches(B, R, range(n_timed + 1), dev, model_type)
    trainer.step(batches[n_timed])  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    steps = []
    for s in range(n_timed):
        t0 = time.perf_counter()
        d = trainer.step(batches[s])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ok = finite(trainer, d)
        steps.append(dict(step=s, ms=ms, loss=float(d["loss"]),
                          psnr=float(d["psnr"]),
                          compact_count=d["compact_count"], finite=ok))
        check(ok, f"train step {s}: non-finite loss or gradient")
    launches = dict(_build.LAUNCHES)
    check(all(launches[k] > 0 for k in need),
          f"a kernel of the train path was never launched: {launches}")
    check(all(launches[k] == 0 for k in absent),
          f"a kernel off the train path was launched: {launches}")
    prof = profile_call(lambda: trainer.step(batches[0]), "step")

    losses = []
    for s in range(n_fixed):  # one fixed batch: the loss must fall
        d = trainer.step(batches[1])
        check(finite(trainer, d), f"fixed-batch step {s}: non-finite")
        losses.append(float(d["loss"]))
    check(losses[-1] < losses[0], f"loss did not fall over {n_fixed} "
          f"steps: {losses[0]} -> {losses[-1]}")
    med = float(np.median([st["ms"] for st in steps]))
    summary = {"rays_per_step": B * R, "steps": len(steps),
               "median_step_ms": med,
               "train_rays_per_s": B * R / (med / 1e3),
               "mean_train_rays_per_s": B * R * len(steps)
               / (sum(st["ms"] for st in steps) / 1e3),
               "median_compact_count": float(np.median(
                   [st["compact_count"] for st in steps])),
               "launches": launches,
               "launches_per_step": {k: v / len(steps)
                                     for k, v in launches.items()},
               "fixed_batch_loss_first": losses[0],
               "fixed_batch_loss_last": losses[-1]}
    return steps, summary, prof, losses


def _grad_groups(system):
    import torch

    groups = {"field": system.scene.nerf, "fine_field": system.scene.nerf_fine,
              "body_params": system.body_params}
    # a parameter the rig does not use has no gradient (the SMPL-X
    # expression with 10 shape directions): zeros on both sides
    return {k: torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).detach().reshape(-1)
                          .cpu().double() for p in m.parameters()])
            for k, m in groups.items()}


def train_parity(dev, cfg=FLAGSHIP_CFG, make_rig=smpl_rig,
                 model_type: str = "smpl", B: int = 2, R: int = 128):
    """One full-width step with B x R rays on the card (kernels) and on the
    CPU (plain versions) from the same parameters and noise."""
    import torch

    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.training.system import RowsCompactTrainer
    from animnerf_tpu_torch.utils.rng import draw_noise

    # Bounds. f32: the kernels and the plain versions sum in other orders
    # (per-split partials in the MLP backward, cuBLAS vs CPU matmuls in
    # the geometry and the plain MLP),
    # and last-bit geometry differences flip discrete choices of the step
    # (a sample's validity at the dis_threshold edge, an inverse-CDF bin);
    # the normal term differentiates a 2^9-frequency encoding at jittered
    # template vertices. bf16: besides, tensor-core and CPU sum orders
    # flip bf16 roundings between layers.
    bounds = {"float32": dict(loss_rtol=1e-3, grad_rel_l2=2e-2,
                              param_abs=1e-5),
              "bfloat16": dict(loss_rtol=2e-2, grad_rel_l2=1e-1,
                               param_abs=1e-4)}
    out = {}
    for dtype, bd in bounds.items():
        cfg_d = dict(cfg, compute_dtype=dtype,
                     train={"optimizer": {"type": "sgd", "momentum": 0.9}})
        res = {}
        for dv in (dev, "cpu"):
            system = AnimNeRFSystem(cfg_d, make_rig(), device=dv, seed=0)
            noise = draw_noise(torch.Generator().manual_seed(7), B, R,
                               system.renderer_cfg,
                               system.body_model.num_verts).to(dv)
            trainer = RowsCompactTrainer(system, steps_per_epoch=100)
            d = trainer.step(train_batches(B, R, [5], dv, model_type)[0],
                             noise)
            res[dv] = ({k: float(v) for k, v in d.items()},
                       _grad_groups(system),
                       {k: p.detach().cpu() for k, p in
                        system.named_parameters()})
        (dg, gg, pg), (dc, gc, pc) = res[dev], res["cpu"]
        loss_rel = max(abs(dg[k] - dc[k]) / max(abs(dc[k]), 1e-12)
                       for k in dc if k != "compact_count")
        grad_rel = {k: float((gg[k] - gc[k]).norm()
                             / max(float(gc[k].norm()), 1e-30)) for k in gc}
        param_abs = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
        out[dtype] = dict(loss_gpu=dg["loss"], loss_cpu=dc["loss"],
                          max_loss_term_rel=loss_rel, grad_rel_l2=grad_rel,
                          max_param_abs_after_sgd=param_abs,
                          compact_count=[dg["compact_count"],
                                         dc["compact_count"]], bounds=bd)
        check(loss_rel <= bd["loss_rtol"]
              and max(grad_rel.values()) <= bd["grad_rel_l2"]
              and param_abs <= bd["param_abs"],
              f"train parity {dtype}: {out[dtype]}")
    return out


# ------------------------------------------------------------------- main


def main() -> int:
    import torch

    import animnerf_tpu_torch  # noqa: F401  (fails outside the checkout)
    from animnerf_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(CKPT):
        print(f"chip_smoke: no checkpoint at {CKPT}", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    lib = _build.kernel_library()
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "cached": lib.cached, "library": os.path.relpath(lib.path, ROOT),
          "ptxas": ptxas})

    ck, system, bp, tmpl, ctx = scale512("cuda")
    t0 = time.perf_counter()
    lines = kernel_lines(system, ctx)
    lines.update(kernel_lines_train("cuda"))
    for name, line in lines.items():
        emit(dict(phase="kernel", name=name, **line))
    emit({"phase": "kernels_done", "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    angles = [3, 17, 29, 41, 55]
    views, serve_launches, prof, _ = render_turntable(system, bp, tmpl,
                                                      angles)
    for v in views:
        emit(dict(phase="view", **v))
    emit(dict(phase="profile", **prof))
    emit({"phase": "slice", "views": len(views),
          "median_view_ms": float(np.median([v["ms"] for v in views])),
          "launches": serve_launches,
          "launches_per_view": {k: v / len(views)
                                for k, v in serve_launches.items()},
          "seconds": time.perf_counter() - t0})
    check(all(serve_launches[k] > 0 for k in SERVE_KERNELS)
          and serve_launches["knn_exact"] == serve_launches["min_dist"]
          == serve_launches["knn_packed"] == 0,
          f"the serving path launched the wrong kernels: {serve_launches}")

    t0 = time.perf_counter()
    parity = slice_parity(ck, bp, tmpl)
    emit({"phase": "slice_parity", **parity,
          "seconds": time.perf_counter() - t0})
    del system, ctx

    t0 = time.perf_counter()
    steps, summary, prof, losses = train_phase(
        "cuda", absent=("knn_exact", "min_dist", "knn_packed"))
    for st in steps:
        emit(dict(phase="train_step", **st))
    emit(dict(phase="train_profile", **prof))
    emit(dict(phase="train", **summary, fixed_batch_losses=losses,
              seconds=time.perf_counter() - t0))
    launches = summary["launches"]

    t0 = time.perf_counter()
    tparity = train_parity("cuda")
    emit({"phase": "train_parity", **tparity,
          "seconds": time.perf_counter() - t0})

    # ---- SMPL-X: the exact kNN and the min-distance pre-pass
    t0 = time.perf_counter()
    xlines = kernel_lines_smplx("cuda")
    for name, line in xlines.items():
        emit(dict(phase="kernel", name=name, **line))
    lines.update(xlines)

    angles = [3, 29, 55]
    xviews, xserve, prof, bviews, agree = smplx_serve(angles)
    for v in xviews:
        emit(dict(phase="smplx_view", **v))
    emit(dict(phase="smplx_profile", **prof))
    emit({"phase": "smplx_serve", "views": len(xviews),
          "median_view_ms": float(np.median([v["ms"] for v in xviews])),
          "median_view_ms_boxes": float(np.median([v["ms"]
                                                   for v in bviews])),
          "survivors_boxes": [[v["n_coarse"], v["n_fine"]] for v in bviews],
          "max_abs_img_exact_vs_boxes": agree, "launches": xserve,
          "launches_per_view": {k: v / len(xviews)
                                for k, v in xserve.items()},
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    emit({"phase": "smplx_serve_parity", **smplx_serve_parity(),
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    steps, xsummary, prof, losses = train_phase(
        "cuda", SMPLX_CFG, smplx_rig, "smplx", n_timed=10, n_fixed=20,
        need=SMPLX_TRAIN_KERNELS, absent=("knn", "min_dist", "knn_packed"))
    for st in steps:
        emit(dict(phase="smplx_train_step", **st))
    emit(dict(phase="smplx_train_profile", **prof))
    emit(dict(phase="smplx_train", **xsummary, fixed_batch_losses=losses,
              seconds=time.perf_counter() - t0))

    t0 = time.perf_counter()
    emit({"phase": "smplx_train_parity",
          **train_parity("cuda", SMPLX_CFG, smplx_rig, "smplx"),
          "seconds": time.perf_counter() - t0})

    # ---- k_neigh 8: kernel 8 in place of kernel 1, kernels 2, 5, 9 at K=8,
    # on the rigs with one-hot LBS weights (rigid_lbs), so that the warp
    # blends several of the 8 neighbours
    t0 = time.perf_counter()
    ck, _, bp, tmpl, _ = scale512("cpu")
    system8 = scale512_system(ck, "cuda", rigid=True, k_neigh=8)
    k8views, k8serve, prof, _ = render_turntable(system8, bp, tmpl,
                                                 [3, 29, 55])
    for v in k8views:
        emit(dict(phase="k8_view", **v))
    emit(dict(phase="k8_profile", **prof))
    emit({"phase": "k8_serve", "views": len(k8views),
          "median_view_ms": float(np.median([v["ms"] for v in k8views])),
          "launches": k8serve,
          "launches_per_view": {k: v / len(k8views)
                                for k, v in k8serve.items()},
          "seconds": time.perf_counter() - t0})
    check(all(k8serve[k] > 0 for k in K8_SERVE_KERNELS)
          and k8serve["knn"] == k8serve["knn_exact"] == k8serve["min_dist"]
          == 0, f"k_neigh 8 serving launched the wrong kernels: {k8serve}")
    del system8

    t0 = time.perf_counter()
    # the seeded rig under slice_parity's bounds; the rigid rig (several
    # neighbours blended) in f32 under its PSNR bound
    emit({"phase": "k8_serve_parity",
          **slice_parity(ck, bp, tmpl, k_neigh=8),
          "rigid_lbs": slice_parity(ck, bp, tmpl, rigid=True,
                                    bounds=PARITY_BOUNDS[1:], psnr_only=True,
                                    k_neigh=8),
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    steps, k8summary, prof, losses = train_phase(
        "cuda", K8_CFG, rigid_smpl_rig, n_timed=10, n_fixed=20,
        need=K8_TRAIN_KERNELS, absent=("knn", "knn_exact", "min_dist"))
    for st in steps:
        emit(dict(phase="k8_train_step", **st))
    emit(dict(phase="k8_train_profile", **prof))
    emit(dict(phase="k8_train", **k8summary, fixed_batch_losses=losses,
              seconds=time.perf_counter() - t0))

    t0 = time.perf_counter()
    emit({"phase": "k8_train_parity",
          **train_parity("cuda", K8_CFG, rigid_smpl_rig),
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    _build.reset_launches()
    # f32 only: its bounds are the tighter, and the kNN is f32 either way
    xparity8 = smplx_serve_parity(cfg=dict(SMPLX_CFG, k_neigh=8),
                                  bounds=PARITY_BOUNDS[1:])
    x8launches = dict(_build.LAUNCHES)
    check(x8launches["knn_exact"] > 0 and x8launches["knn"]
          == x8launches["knn_packed"] == 0,
          f"SMPL-X k_neigh 8 launched the wrong kNN: {x8launches}")
    emit({"phase": "smplx_k8_parity", **xparity8, "launches": x8launches,
          "seconds": time.perf_counter() - t0})

    # ---- kernel 10 and the port's kNN tool
    t0 = time.perf_counter()
    mlines = kernel_lines_mxu("cuda")
    for name, line in mlines.items():
        emit(dict(phase="kernel", name=name, **line))
    lines.update(mlines)
    brows, blaunches = bench_knn_phase()
    for r in brows:
        emit(dict(phase="bench_knn", **r))
    emit({"phase": "bench_knn_done", "launches": blaunches,
          "seconds": time.perf_counter() - t0})

    # launches, each from the main path that runs the kernel: the SMPL
    # train phase's for kernels 1-6; the SMPL-X serve and train phases'
    # (summed) for kernels 7 and 9; the k_neigh 8 serve and train phases'
    # (summed) for kernel 8 and kernels 2 and 5 at K = 8; the SMPL-X
    # k_neigh 8 parity view's (card side) for kernel 9 at K = 8; the kNN
    # tool's for kernel 8 at K = 4 and kernel 10 (one count for both
    # precisions)
    k8 = {k: k8serve[k] + k8summary["launches"][k]
          for k in ("knn_packed", "warp_blend", "scatter")}
    row_launches = dict(
        launches,
        knn_exact=xserve["knn_exact"] + xsummary["launches"]["knn_exact"],
        min_dist=xserve["min_dist"] + xsummary["launches"]["min_dist"],
        knn_packed=k8["knn_packed"], warp_blend_k8=k8["warp_blend"],
        scatter_k8=k8["scatter"], knn_exact_k8=x8launches["knn_exact"],
        knn_packed_k4=blaunches["knn_packed"], knn_mxu=blaunches["knn_mxu"],
        knn_mxu_default=blaunches["knn_mxu"])
    rows = []
    for name, (src, replaces) in KERNELS.items():
        ln = lines[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": row_launches[name],
                     "max_abs_err": ln["max_abs_err"], "ms": ln["ms"],
                     "plain_ms": ln["plain_ms"], "bound_ms": ln["bound_ms"],
                     "bound_by": ln["bound_by"],
                     "library_ms": ln["library_ms"]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
