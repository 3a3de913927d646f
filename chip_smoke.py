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
     H100's peak);
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
  8. the kernels summary line, the card line, then the final status line.
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
PEAK_BYTES = 3.35e12


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


def scale512(device):
    """The trained scale512 system on the seed-3 rig, its frame params and
    the frame geometry."""
    import torch

    from animnerf_tpu_torch.data.synthetic import make_body_model
    from animnerf_tpu_torch.models.warp import prepare_frame
    from animnerf_tpu_torch.smpl.loader import load_pickle
    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.utils.convert import load_checkpoint

    ck = load_checkpoint(CKPT)
    system = AnimNeRFSystem(ck["cfg"], make_body_model(6890, 24, seed=3),
                            device=device)
    system.load_anim_nerf(ck["anim_nerf"])
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
    from animnerf_tpu_torch.ops.knn_kernel import knn_top4, knn_top4_plain
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
    from animnerf_tpu_torch.ops.knn_kernel import knn_top4, knn_top4_plain
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
    outp = weighted_scatter_rows_plain(i1, w, gr, V)
    torch.cuda.synchronize()
    err = float((out - outp).abs().max())
    # f32 atomics land in a run-dependent order: a few ulps of the
    # largest row sum
    tol = 1e-5 * float(outp.abs().max())
    check(err <= tol, f"scatter: max err {err} > {tol}")
    contrib = (w[:, :, None, :] * gr[:, None]).permute(0, 1, 3, 2) \
        .reshape(-1, 16).contiguous()
    rows = (i1.long() + (torch.arange(B, device=dev) * V)[:, None, None]
            ).reshape(-1)
    flat = torch.zeros(B * V, 16, device=dev)
    lines["scatter"] = dict(
        shape=f"idx/w ({B},4,{N}) g ({B},16,{N}) -> ({B},{V},16)",
        max_abs_err=err, tolerance=tol,
        ms=time_ms(lambda: weighted_scatter_rows(i1, w, gr, V), reps),
        plain_ms=time_ms(lambda: weighted_scatter_rows_plain(i1, w, gr, V),
                         preps),
        # idx, w and g read once, the table written once
        bound_ms=B * (N * (4 + 4 + 16) * 4 + V * 16 * 4) / PEAK_BYTES * 1e3,
        bound_by="bytes",
        library_ms=time_ms(lambda: flat.zero_().index_add_(0, rows, contrib),
                           reps))

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
            bound_by="operations", library_ms=None)
        del a, a2, b
    return lines


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
}
SERVE_KERNELS = ("knn", "warp_blend", "fused_mlp", "permute_lanes")


# ------------------------------------------------------------------ slice


def render_turntable(system, bp, tmpl, angles, H=512, W=512):
    import torch

    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.render.inference import (
        Renderer,
        turntable_rotation,
    )

    renderer = Renderer(system)
    rays = frame_rays(H, W)

    def frames(views):
        return [dict(body_params=bp, body_tmpl=tmpl, rays=rays,
                     P=turntable_rotation(i, 64), img_wh=(W, H))
                for i in views]

    for _ in renderer.render_stream(frames(angles[:1])):  # warm-up view
        pass
    torch.cuda.synchronize()
    _build.reset_launches()
    views = []
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
        check(finite, f"view {angles[k]}: non-finite output")
        check(views[-1]["body_px"] > 500 and n_c > 0 and n_f > 0,
              f"view {angles[k]}: body not visible ({views[-1]})")
        t0 = time.perf_counter()
    launches = dict(_build.LAUNCHES)

    def one_view():
        for _ in renderer.render_stream(frames(angles[:1])):
            pass

    return views, launches, profile_call(one_view, "view")


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
    return {f"{what}_ms_profiled": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in events[:15]]}


def slice_parity(ck, system, bp, tmpl, H=96, W=96):
    """One view on the card (kernels) and on the CPU (plain versions)."""
    from animnerf_tpu_torch.data.synthetic import make_body_model
    from animnerf_tpu_torch.render.inference import (
        Renderer,
        turntable_rotation,
    )
    from animnerf_tpu_torch.system import AnimNeRFSystem

    rays = frame_rays(H, W)
    P = turntable_rotation(17, 64)
    out = {}
    for dtype, bound in (("bfloat16", (5e-2, 40.0)), ("float32", (1e-3, 60.0))):
        cfg = dict(ck["cfg"], compute_dtype=dtype)
        gpu = AnimNeRFSystem(cfg, make_body_model(6890, 24, seed=3),
                             device="cuda")
        gpu.load_anim_nerf(ck["anim_nerf"])
        cpu = AnimNeRFSystem(cfg, make_body_model(6890, 24, seed=3),
                             device="cpu")
        cpu.load_anim_nerf(ck["anim_nerf"])
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
            counts_cpu=rc.last_counts)
        check(err <= bound[0] and psnr >= bound[1],
              f"slice parity {dtype}: max abs {err}, PSNR {psnr}")
    return out


# ------------------------------------------------------------------ train

# the flagship of __graft_entry__._flagship_system / bench.py, in the
# reference's config keys (frames 1..8 give num_frames 8)
FLAGSHIP_CFG = {"n_samples": 64, "n_importance": 32, "use_view": False,
                "freqs_xyz": 10, "num_frames": 8, "gender": "neutral",
                "compute_dtype": "bfloat16"}


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


def train_batches(B: int, n_rays: int, seeds, device):
    """bench.py's batch (random targets and fg/bg points from seed 0,
    seed-2 template poses with zero transl), one per ray seed."""
    import torch

    from animnerf_tpu_torch.data.synthetic import random_pose_params

    rng = np.random.default_rng(0)
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


def train_phase(dev, B: int = 16, R: int = 1024):
    """The bench.py step: warm-up, 20 timed steps, one profiled step, then
    30 steps on one fixed batch."""
    import torch

    from animnerf_tpu_torch.data.synthetic import make_body_model
    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.training.system import RowsCompactTrainer

    system = AnimNeRFSystem(FLAGSHIP_CFG, make_body_model(6890, 24, seed=0),
                            device=dev, seed=0)
    trainer = RowsCompactTrainer(system, steps_per_epoch=100)
    batches = train_batches(B, R, range(21), dev)
    trainer.step(batches[20])  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    steps = []
    for s in range(20):
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
    check(all(launches[k] > 0 for k in KERNELS),
          f"a kernel of the train path was never launched: {launches}")
    prof = profile_call(lambda: trainer.step(batches[0]), "step")

    losses = []
    for s in range(30):  # one fixed batch: the loss must fall
        d = trainer.step(batches[1])
        check(finite(trainer, d), f"fixed-batch step {s}: non-finite")
        losses.append(float(d["loss"]))
    check(losses[-1] < losses[0],
          f"loss did not fall over 30 steps: {losses[0]} -> {losses[-1]}")
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
               "fixed_batch_loss_30": losses[-1]}
    return steps, summary, prof, losses


def _grad_groups(system):
    import torch

    groups = {"field": system.scene.nerf, "fine_field": system.scene.nerf_fine,
              "body_params": system.body_params}
    return {k: torch.cat([p.grad.detach().reshape(-1).cpu().double()
                          for p in m.parameters()])
            for k, m in groups.items()}


def train_parity(dev, B: int = 2, R: int = 128):
    """One full-width step with B x R rays on the card (kernels) and on the
    CPU (plain versions) from the same parameters and noise."""
    import torch

    from animnerf_tpu_torch.data.synthetic import make_body_model
    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.training.system import RowsCompactTrainer
    from animnerf_tpu_torch.utils.rng import draw_noise

    # Bounds. f32: the kernels and the plain versions sum in other orders
    # (f32 atomics in the scatter, per-split partials in the MLP
    # backward, cuBLAS vs CPU matmuls in the geometry and the plain MLP),
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
        cfg = dict(FLAGSHIP_CFG, compute_dtype=dtype,
                   train={"optimizer": {"type": "sgd", "momentum": 0.9}})
        res = {}
        for dv in (dev, "cpu"):
            system = AnimNeRFSystem(cfg, make_body_model(6890, 24, seed=0),
                                    device=dv, seed=0)
            noise = draw_noise(torch.Generator().manual_seed(7), B, R,
                               system.renderer_cfg,
                               system.body_model.num_verts).to(dv)
            trainer = RowsCompactTrainer(system, steps_per_epoch=100)
            d = trainer.step(train_batches(B, R, [5], dv)[0], noise)
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
    views, serve_launches, prof = render_turntable(system, bp, tmpl, angles)
    for v in views:
        emit(dict(phase="view", **v))
    emit(dict(phase="profile", **prof))
    emit({"phase": "slice", "views": len(views),
          "median_view_ms": float(np.median([v["ms"] for v in views])),
          "launches": serve_launches,
          "launches_per_view": {k: v / len(views)
                                for k, v in serve_launches.items()},
          "seconds": time.perf_counter() - t0})
    check(all(serve_launches[k] > 0 for k in SERVE_KERNELS),
          f"a kernel of the serving path was never launched: "
          f"{serve_launches}")

    t0 = time.perf_counter()
    parity = slice_parity(ck, system, bp, tmpl)
    emit({"phase": "slice_parity", **parity,
          "seconds": time.perf_counter() - t0})
    del system, ctx

    t0 = time.perf_counter()
    steps, summary, prof, losses = train_phase("cuda")
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

    rows = []
    for name, (src, replaces) in KERNELS.items():
        ln = lines[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
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
