#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``animnerf_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printed as a JSON line; any failed check raises (exit != 0):
  1. card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: the four CUDA kernels from ``animnerf_tpu_torch/csrc``;
  3. one line per kernel at the serving path's shapes (inputs from a
     seed): its max error against its plain PyTorch version on the card
     beside the stated tolerance, kernel / plain / library-call times
     (median of CUDA-event timings after a warm-up) and the least time
     the card could take (bytes or operations over the H100's peak);
  4. the slice: the trained scale512 checkpoint on the seed-3 SMPL rig,
     a 512x512 turntable rendered through ``Renderer.render_stream``,
     launch counts reset just before and read just after; then one more
     view under torch.profiler (device time by kernel, idle share);
  5. slice parity: one view at 96x96 rendered on the card with the
     kernels and on the CPU with the plain versions;
  6. the kernels summary line, then the final status line.
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
    """Check and time each kernel at the serving path's shapes."""
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


KERNELS = {
    "knn": ("animnerf_tpu_torch/csrc/knn.cu",
            "animnerf_tpu/ops/knn_pallas.py:268"),
    "warp_blend": ("animnerf_tpu_torch/csrc/warp_blend.cu",
                   "animnerf_tpu/ops/warp_blend.py:48"),
    "fused_mlp": ("animnerf_tpu_torch/csrc/fused_mlp.cu",
                  "animnerf_tpu/ops/fused_mlp.py:182"),
    "permute_lanes": ("animnerf_tpu_torch/csrc/sort_lanes.cu",
                      "animnerf_tpu/ops/sort_lanes.py:29"),
}


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
    return views, launches, profile_view(renderer, frames(angles[:1]))


def profile_view(renderer, frames):
    """Device time by kernel over one more view (torch.profiler); the
    launch counts of the main path were read before this."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in renderer.render_stream(frames):
            pass
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
    return {"view_ms_profiled": wall, "device_busy_ms": busy,
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
    for name, line in lines.items():
        emit(dict(phase="kernel", name=name, **line))
    emit({"phase": "kernels_done", "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    angles = [3, 17, 29, 41, 55]
    views, launches, prof = render_turntable(system, bp, tmpl, angles)
    for v in views:
        emit(dict(phase="view", **v))
    emit(dict(phase="profile", **prof))
    emit({"phase": "slice", "views": len(views),
          "median_view_ms": float(np.median([v["ms"] for v in views])),
          "launches": launches,
          "launches_per_view": {k: v / len(views)
                                for k, v in launches.items()},
          "seconds": time.perf_counter() - t0})
    check(all(launches[k] > 0 for k in KERNELS),
          f"a kernel of the path was never launched: {launches}")

    t0 = time.perf_counter()
    parity = slice_parity(ck, system, bp, tmpl)
    emit({"phase": "slice_parity", **parity,
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
