#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``animnerf_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printed as a JSON line; any failed check raises (exit != 0):
  1. card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels from ``animnerf_tpu_torch/csrc`` (with the
     kNN sweeps' SASS instructions per pair: kernels 1, 8 and 9); then the
     bf16 MLP backward's weight-gradient pass alone (``fused_mlp_wgrad``,
     on wgmma with MN-major operands) on scratches the main kernel wrote,
     at a full chunk, 128 points and a ragged 131,072 - 37, against its
     plain version in f64, bit-equal across two runs, timed beside the
     same products and sums as PyTorch calls, with its SASS's wgmma count;
  3. one line per kernel, at the serving path's shapes (kNN, warp-blend,
     fused MLP, lane permute) and at the training step's (kNN with the
     tile skip, weighted scatter, fused MLP backward in bf16 and f32),
     inputs from a seed: its max error against its plain PyTorch version
     on the card beside the stated tolerance, kernel / plain /
     library-call times (median of CUDA-event timings after a warm-up)
     and the least time the card could take (bytes or operations over the
     H100's peak); the scatter and the MLP forward and backward also
     bit-equal across two launches, the MLP forward (on wgmma) checked at
     a second encoding width (n_freqs 7) and given its share of the bound,
     the scatter beside the deterministic library scatter (and the atomic
     one) with its kernels' device time by name, the warp-blend also in
     its residual-free mode, and the bf16 MLP backward's main kernel
     (recompute + dgrad, on wgmma) and weight-gradient kernels timed apart
     in one profiled call; the kNN lines of kernels 1 and 8 with their
     share of the bound, their sweep's points per thread and its SASS
     instructions per pair; then kernels 1 and 8 at edge shapes (N = 2^20
     - 37, V in {K, 1025, 8192}, K in {1, 4, 8, 16}), each bit-equal to
     its plain version; the scatter at K in {1, 4, 8, 16} with one, two
     and three radix passes (bit-equal to its plain version and to a
     second run) and the warp-blend on every family's row width and an
     unaligned table (within 1e-4, residual-free out bit-equal);
  4. serving: the trained scale512 checkpoint on the seed-3 SMPL rig, a
     512x512 turntable rendered through ``Renderer.render_stream``,
     launch counts reset just before and read just after; then one more
     view under torch.profiler (device time by kernel, the MLP forward's
     and the kNN's shares, the scatter's and the warp-blend's time and
     launches, idle share); then ``warp_blend_view``: kernel 2 on the
     arguments of a view's first call (its coarse warp), within 1e-4 of
     its plain version, with the residual-free mode's time and out;
  5. serving parity: one view at 96x96 rendered on the card with the
     kernels and on the CPU with the plain versions;
  5a. dense_serve: the same system through the dense route
     (``Renderer(compact_samples=False)``: every sample of every culled
     ray through the kNN, warp-blend and MLP kernels, 32,768-ray slabs)
     on views 3, 29 and 55, with the kNN's all-far skip
     (``knn_far_skip``) off, then on: per view the host-clock time, the
     rays rendered and the share of 1024-point kNN groups the far pass
     skipped; the launch counts of each mode; one profiled view each way;
     the images with the skip off and on bit-equal, and within the bf16
     parity bounds of the compacted image of the same view;
  5b. dense_eval: ``make_eval_step`` on the 262,144 rays of one 512x512
     frame (no ray cull: most kNN groups are background) in 32,768-ray
     slabs, the skip off, then on: frame time, launches, skipped share,
     one profiled frame each way; outputs off and on bit-equal, the fine
     image within the bf16 bounds of the compacted renderer's frame;
  5c. the far-skip kernel lines on the points of one dense view's first
     kNN call (its first slab's coarse samples): the far pass alone
     (``csrc/knn_far.cu``: flags and skipped outputs bit-equal to the
     plain version), kernels 1, 8 (K = 8) and 9 (K = 4) with the far
     skip (bit-equal to their plain versions, the same validity as
     without it; times with and without the skip; the bound from the
     pairs the kept groups sweep plus the far pass), kernel 1 with the
     tile skip and the far skip on the training step's Morton-ordered
     points; one training step with the skip off and on (loss terms and
     gradients bit-equal); then edge shapes (N = 2^20 - 37, the last
     group partial, its padding at the origin keeping it from skipping
     or, with the cloud moved away, not; K in {1, 4, 8, 16}), each
     bit-equal to its plain version;
  6. train: the flagship training step of ``bench.py`` (V=6890 / J=24
     seed-0 rig, 8x256 coarse + fine MLPs in bf16, 64 + 32 samples,
     16 x 1024 rays, six-term loss, Adam) through
     ``RowsCompactTrainer.step``: one warm-up step, then 20 timed steps on
     distinct ray batches with the launch counts reset just before and
     read just after, and one more step under torch.profiler; the
     ``scatter_step`` line: kernel 5 on the inputs of one more step's two
     scatter calls (coarse, fine), with their row statistics, bit-equal to
     its plain version and to a second run, beside both library scatters;
     then 30 steps on one fixed batch, whose loss must fall, with finite
     losses and gradients throughout;
  7. train parity: one step at full width with 2 x 128 rays on the card
     (kernels) and on the CPU (plain versions) from the same parameters
     and noise, in f32 and in bf16: loss terms, gradients per parameter
     group and the parameters after one SGD-momentum step;
  8. SMPL-X kernel lines: the exact kNN (kernel 9, with and without its
     cull, at K = 4 and 8, random-order points: the swept share, both
     bounds, SASS per pair) and the nearest-vertex distance against the
     seed-0 SMPL-X rig (V=10475, J=55), each bit-equal to its plain
     version on the card; then kernel 9 at edge shapes (N = 2^20 - 37,
     V in {K, 513, 8193, 10475}, K in {1, 4, 8, 16}, and a tie-rich 1/64
     grid cloud), with and without its cull, each bit-equal to its plain
     version, and its rows kernel to its plain version;
  9. smplx_serve: the flagship field with random weights from a seed (the
     sigma heads' biases raised so the 0.2 m shell is opaque) on that rig,
     a 512x512 turntable through ``Renderer.render_stream`` with
     ``prepass="exact"``, launch counts reset just before and read just
     after (the packed kNN must not launch, kernel 9 launches with its
     cull), two profiled views whose device-busy times must agree within
     10%, the kNN calls of one more view (kernel 9's launches and points
     per launch), and the same views with ``prepass="boxes"``, whose
     images must agree; then kernel 9's lines on the points that view's
     coarse warp passed to it, at K = 4 and 8 (as in phase 8), and kernel
     2 on its first warp-blend call (``warp_blend_smplx``, F = 71);
 10. smplx_serve_parity: one 64x64 view with prepass="exact" on the card
     and on the CPU, bf16 and f32; smplx_dense: a dense 64x64 view with
     the far skip off and on (kernel 9 and the far pass; images
     bit-equal);
 11. smplx_train: the bench.py step on the SMPL-X rig with every SMPL-X
     body parameter optimised: one warm-up step, 10 timed steps, one
     profiled step, the kNN calls of one more step (kernel 9's launches
     and points per launch), 20 steps on one fixed batch whose loss must
     fall;
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
     profiled view); k8_dense (a dense 64x64 view with the far skip off
     and on: kernel 8 and the far pass, images bit-equal);
     k8_serve_parity (phase 5 at k_neigh 8); k8_train (the
     bench.py step with k_neigh 8: warm-up, 10 timed steps, one profiled,
     ``scatter_step_k8`` on one more step's scatter calls, 20 on one batch
     whose loss must fall); ``warp_blend_view_k8`` on a k8 view's first
     call; k8_train_parity (phase 7 at
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
# kernels 1 and 8: the non-FMA f32 operations that any exact sweep must do
# per (point, vertex) pair, over PEAK_F32_NONFMA: the 3 multiplies and 3
# adds of the dot form (csrc/knn_keys.cuh row_dot, each rounded on its own,
# so none is an FMA). The add of |p|^2, the clamp and the key are needed
# only by the pairs that can enter the top-K (knn_sweep.cuh's filter), and
# the compare that decides that need not be f32 work (an integer key
# compare does it as well), so none of them is counted
KNN_PAIR_OPS = 6.0
# kernel 9: the non-FMA f32 operations its rounding demands per swept
# (point, vertex) pair, over PEAK_F32_NONFMA: 3 subtractions, 3 multiplies,
# 2 adds (each rounded on its own) and the compare against the tile list
EXACT_PAIR_OPS = 9.0
# kernels 1, 8 (the sweep and its rows kernel) and 9 (its sweep and rows
# kernel, knn_exact_kernel and knn_exact_rows), and the far pass of their
# all-far skip, by profiler name
KNN_KERNEL_NAMES = ("knn_sweep::", "knn_rows_kernel", "knn_exact",
                    "knn_far_kernel")
# chunk size of the plain kNN versions on the card (a (chunk x V) matrix):
# large chunks keep their per-chunk launches few
PLAIN_MAX_ELEMS = 1 << 26
# the exact kNN's plain version: its per-tile rule loops k x V / 512 times
# a chunk, so it takes larger chunks (~6 GB of d2 and keys)
PLAIN_EXACT_MAX_ELEMS = 1 << 28
# kernel 9 at (1, 2^20) x 10,475 before its redesign (H100 80GB HBM3,
# 700 W): the kernel lines' earlier times by K
PREV_EXACT_MS = {4: 6.431, 8: 10.489}
# card vs CPU image bounds per compute dtype: (max |img| difference, PSNR)
PARITY_BOUNDS = (("bfloat16", (5e-2, 40.0)), ("float32", (1e-3, 60.0)))
# the bf16 MLP backward at 2^20 points before its main kernel moved to
# wgmma (H100 80GB HBM3, 700 W): the kernel line's earlier time
PREV_BWD_MS = 55.518
# the bf16 MLP backward's weight gradients, head and bias sums and split
# reduction at 2^20 points on the split-K wmma kernels they replaced, in a
# profiled call (H100 80GB HBM3, 700 W)
PREV_WGRAD_MS = 13.204
# the bf16 MLP forward at 2^21 points on the wmma kernel it replaced
# (H100 80GB HBM3, 700 W): the kernel line's earlier time
PREV_FWD_MS = 20.327
# the weighted scatter (kernel 5: torch.sort, then a row kernel) and the
# warp-blend (kernel 2: scalar loads) before their redesign, by K (H100
# 80GB HBM3, 700 W): the kernel lines' earlier times
PREV_SCATTER_MS = {4: 0.549, 8: 0.762}
PREV_WARP_BLEND_MS = {4: 0.573, 8: 1.003}


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


def mlp_fwd_errors(o, op, what: str):
    """The bf16 MLP forward against its plain version: same rounding
    points, but tensor-core and cuBLAS accumulation orders differ, which
    can flip a bf16 rounding between layers. rgb within 2e-2, sigma within
    3e-2 + 2e-2 |sigma|, rows 4..7 exactly zero. Returns (max abs error,
    rgb's, sigma's largest excess over its bound)."""
    err_rgb = float((o[0, :3] - op[0, :3]).abs().max())
    sig_excess = float(((o[0, 3] - op[0, 3]).abs()
                        - (3e-2 + 2e-2 * op[0, 3].abs())).max())
    check(err_rgb <= 2e-2 and sig_excess <= 0.0,
          f"fused_mlp bf16 ({what}): rgb err {err_rgb}, sigma excess "
          f"{sig_excess}")
    check(bool((o[0, 4:] == 0).all()),
          f"fused_mlp ({what}): rows 4..7 must be zero")
    return (max(err_rgb, float((o[0, 3] - op[0, 3]).abs().max())), err_rgb,
            sig_excess)


def sass_functions(text: str) -> dict:
    """cuobjdump -sass output -> {mangled name: [(address, instruction)]}."""
    import re

    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def sweep_path(ins) -> dict:
    """The instructions a kNN sweep issues per row when no key enters: of
    the innermost loops that hold broadcast row loads (LDS.128), the one
    whose walk loads the most rows, walked from its head, taking every
    forward branch that stays inside the loop (the branch past the insert)
    until the back edge. Returns its instruction and row counts."""
    import re

    addr = [a for a, _ in ins]
    loops = []
    for a, t in ins:
        m = re.match(r"(@!?U?P\w+ )?BRA(\.\w+)* (0x[0-9a-f]+)$", t)
        if m and int(m.group(3), 16) < a and any(
                "LDS" in u and ".128" in u
                for b, u in ins if int(m.group(3), 16) <= b <= a):
            loops.append((int(m.group(3), 16), a))
    best = {}
    for head, back in loops:
        if any((h, b) != (head, back) and head <= h and b <= back
               for h, b in loops):
            continue  # not innermost
        i, count, rows = addr.index(head), 0, 0
        while True:
            a, t = ins[i]
            count += 1
            rows += "LDS" in t and ".128" in t
            m = re.match(r"@!?U?P\w+ BRA(\.\w+)* (0x[0-9a-f]+)$", t)
            if a == back:
                break
            if m and a < int(m.group(2), 16) <= back:
                i = addr.index(int(m.group(2), 16))
            else:
                i += 1
        key = (rows, head - back)
        if rows and (not best or key > best["key"]):
            best = {"key": key, "loop_instructions": count,
                    "rows_per_iteration": rows}
    best.pop("key", None)
    return best


def library_sass(lib_path: str) -> dict:
    """sass_functions of the built library (cuobjdump -sass)."""
    from animnerf_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    return sass_functions(subprocess.run(
        [cuobjdump, "-sass", lib_path], capture_output=True, text=True,
        timeout=300).stdout)


def sweep_sass(funcs: dict) -> dict:
    """{(K, skip, insert): {points_per_thread, sass_per_pair, ...}} for the
    sweep kernels of kernels 1 and 8 among the library's SASS functions;
    insert is "top4" for kernel 1's Top4Insert, "packed" for kernel 8's
    PackedInsert<K>."""
    import re

    out = {}
    for name, ins in funcs.items():
        m = re.search(r"sweep_kernelILi(\d+)ELi(\d+)ELb([01])E.*?"
                      r"(Top4Insert|PackedInsert)", name)
        if not m:
            continue
        K, P, skip = int(m.group(1)), int(m.group(2)), m.group(3) == "1"
        insert = "top4" if m.group(4) == "Top4Insert" else "packed"
        check((K, skip, insert) not in out,
              f"two sweep kernels for {(K, skip, insert)} in the SASS")
        path = sweep_path(ins)
        if path:
            out[(K, skip, insert)] = dict(
                points_per_thread=P, sass_loop_instructions=path[
                    "loop_instructions"],
                sass_rows_per_iteration=path["rows_per_iteration"],
                sass_per_pair=path["loop_instructions"]
                / (path["rows_per_iteration"] * P))
    return out


def exact_sass(funcs: dict) -> dict:
    """{K: {points_per_thread, sass_per_pair, ...}} for kernel 9's sweep
    (csrc/knn_exact.cu knn_exact_kernel<K, P>) among the library's SASS
    functions: sweep_path's walk of its row loop, past the insert."""
    import re

    out = {}
    for name, ins in funcs.items():
        m = re.search(r"knn_exact_kernelILi(\d+)ELi(\d+)E", name)
        if not m:
            continue
        K, P = int(m.group(1)), int(m.group(2))
        check(K not in out, f"two exact kNN kernels for K={K} in the SASS")
        path = sweep_path(ins)
        if path:
            out[K] = dict(points_per_thread=P, sass_loop_instructions=path[
                "loop_instructions"],
                sass_rows_per_iteration=path["rows_per_iteration"],
                sass_per_pair=path["loop_instructions"]
                / (path["rows_per_iteration"] * P))
    return out


def exact_check(pts, verts, k: int) -> dict:
    """Kernel 9 on points (1, N, 3) against verts (1, V, 3) at k, with and
    without its cull: each output must be bit-equal to knn_exact_plain's
    (timed on its one call). Returns the errors, the plain version's ms and
    the share of (point, vertex) pairs the cull swept (the kernel's
    stats)."""
    import torch

    from animnerf_tpu_torch.ops.knn_kernel import knn_exact, knn_exact_plain

    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    dp, ip = knn_exact_plain(pts, verts, k, max_elems=PLAIN_EXACT_MAX_ELEMS)
    e.record()
    e.synchronize()
    stats = torch.zeros(2, dtype=torch.int64, device=pts.device)
    err, mism = 0.0, 0
    for cull in (True, False):
        d, i = knn_exact(pts, verts, k, cull=cull,
                         stats=stats if cull else None)
        torch.cuda.synchronize()
        mism += int((i != ip).sum())
        err = max(err, float((d - dp).abs().max()))
        check(mism == 0 and torch.equal(d, dp),
              f"knn_exact K={k} points {tuple(pts.shape)} verts "
              f"{tuple(verts.shape)} cull={cull}: {mism} index mismatches, "
              f"max err {err}")
    swept, skipped = (int(x) for x in stats.tolist())
    return dict(max_abs_err=err, tolerance=0.0, idx_mismatch=mism,
                bit_equal_cull_and_nocull=True, plain_ms=s.elapsed_time(e),
                swept_share=swept / max(swept + skipped, 1))


def exact_line(pts, verts, k: int, exact: dict, reps: int = 20) -> dict:
    """exact_check, then kernel 9's times with and without its cull, both
    bounds: EXACT_PAIR_OPS per swept pair (bound_ms, what this call's
    culled sweep needs) and per pair (bound_all_ms, the full sweep's), and
    the sweep's points per thread and SASS per pair."""
    from animnerf_tpu_torch.ops.knn_kernel import knn_exact

    N, V = pts.shape[1], verts.shape[1]
    line = exact_check(pts, verts, k)
    share = line["swept_share"]
    ms = time_ms(lambda: knn_exact(pts, verts, k), reps)
    ms_nocull = time_ms(lambda: knn_exact(pts, verts, k, cull=False), reps)
    nbytes = N * 12 + V * 12 + N * 8 * k
    bound = max(EXACT_PAIR_OPS * share * N * V / PEAK_F32_NONFMA,
                nbytes / PEAK_BYTES) * 1e3
    bound_all = max(EXACT_PAIR_OPS * N * V / PEAK_F32_NONFMA,
                    nbytes / PEAK_BYTES) * 1e3
    return dict(shape=f"points (1,{N},3) verts (1,{V},3) K={k}", **line,
                ms=ms, ms_nocull=ms_nocull, bound_ms=bound,
                bound_by="operations", bound_all_ms=bound_all,
                pct_of_bound=100.0 * bound / ms,
                pct_of_bound_nocull=100.0 * bound_all / ms_nocull,
                library_ms=None, **exact[k])


def view_calls(calls: list) -> list:
    """Each captured kNN call again with the exact kernel and its cull:
    points, time (CUDA events, median of 5) and swept share."""
    import torch

    from animnerf_tpu_torch.ops.knn_kernel import knn_exact

    out = []
    for c in calls:
        stats = torch.zeros(2, dtype=torch.int64, device=c["points"].device)
        knn_exact(c["points"], c["verts"], c["k"], stats=stats)
        swept, skipped = (int(x) for x in stats.tolist())
        out.append({"N": c["N"], "k": c["k"], "ms": time_ms(
            lambda: knn_exact(c["points"], c["verts"], c["k"]), 5),
            "swept_share": swept / max(swept + skipped, 1)})
    return out


def capture_knn(fn, keep: bool = False) -> list:
    """The calls fn makes to the warp's kNN entry
    (``animnerf_tpu_torch.models.warp.knn``, wrapped for the call and
    restored after): [{N, V, k}] and, with keep, each call's points and
    vertices (copies)."""
    from animnerf_tpu_torch.models import warp

    calls, orig = [], warp.knn

    def record(points, verts, k=4, **kw):
        c = {"N": int(points.shape[1]), "V": int(verts.shape[1]), "k": k}
        if keep:
            c.update(points=points.detach().clone(),
                     verts=verts.detach().clone())
        calls.append(c)
        return orig(points, verts, k, **kw)

    warp.knn = record
    try:
        fn()
    finally:
        warp.knn = orig
    return calls


# every kernel weighted_scatter_rows launches (csrc/scatter.cu's
# scatter_*_kernel; weighted_scatter_kernel before its redesign), and the
# warp-blend's, by profiler name (not torch's _scatter_gather kernels)
SCATTER_KERNEL_NAMES = ("::scatter_", "weighted_scatter")
WARP_BLEND_KERNEL_NAMES = ("warp_blend",)


def kernel_name(key: str) -> str:
    """A profiler kernel key without its return type, namespace and
    parameters: "warp_blend_fwd_kernel<4>", "scatter_sum_kernel"."""
    key = key.replace("void ", "").replace("(anonymous namespace)::", "")
    return key.split("(")[0]


def capture_scatter(fn) -> list:
    """The calls fn makes to the warp-blend backward's scatter
    (``animnerf_tpu_torch.ops.warp_blend.weighted_scatter_rows``, the name
    ``WarpBlendRows.backward`` calls; wrapped for the call and restored
    after): copies of each call's idx, w and g, and its num_rows."""
    from animnerf_tpu_torch.ops import warp_blend

    calls, orig = [], warp_blend.weighted_scatter_rows

    def record(idx_t, w_t, g, num_rows):
        calls.append({"idx": idx_t.detach().clone(),
                      "w": w_t.detach().clone(), "g": g.detach().clone(),
                      "num_rows": num_rows})
        return orig(idx_t, w_t, g, num_rows)

    warp_blend.weighted_scatter_rows = record
    try:
        fn()
    finally:
        warp_blend.weighted_scatter_rows = orig
    return calls


def capture_warp_blend(fn, keep: int = 1) -> list:
    """The calls fn makes to the warp-blend forward
    (``animnerf_tpu_torch.ops.warp_blend.warp_blend_fwd``, the name
    ``warp_blend_rows`` and ``WarpBlendRows.forward`` call; wrapped for
    the call and restored after): [{N, k}], with copies of the positional
    arguments of the first ``keep`` calls under "args"."""
    from animnerf_tpu_torch.ops import warp_blend

    calls, orig = [], warp_blend.warp_blend_fwd

    def record(*args, **kw):
        c = {"N": int(args[2].shape[2]), "k": int(args[2].shape[1])}
        if len(calls) < keep:
            c["args"] = tuple(a.detach().clone() if hasattr(a, "detach")
                              else a for a in args)
        calls.append(c)
        return orig(*args, **kw)

    warp_blend.warp_blend_fwd = record
    try:
        fn()
    finally:
        warp_blend.warp_blend_fwd = orig
    return calls


def scatter_row_stats(idx, w, g, V: int) -> dict:
    """A scatter call's shape and how its live entries (w != 0 and a
    cotangent column not all zero) spread over the B * V rows: row lengths
    over all rows (max, p99, p50, the empty share) and over live entries
    (the length of the row an entry lands in: p50, p99)."""
    import torch

    B, K, N = idx.shape
    live = (w != 0) & (g != 0).any(1, keepdim=True)
    keys = (idx.long() + (torch.arange(B, device=idx.device)
                          * V)[:, None, None])[live]
    counts = torch.bincount(keys, minlength=B * V).float()
    q = torch.tensor([0.5, 0.99], device=idx.device)
    r50, r99 = (float(x) for x in torch.quantile(counts, q))
    e50, e99 = (float(x) for x in torch.quantile(counts[keys], q)) \
        if keys.numel() else (0.0, 0.0)
    return {"B": B, "K": K, "N": N, "entries": B * K * N,
            "live_entries": int(keys.numel()),
            "live_share": keys.numel() / max(B * K * N, 1), "rows": B * V,
            "row_len_max": int(counts.max()), "row_len_p99": r99,
            "row_len_p50": r50,
            "empty_row_share": float((counts == 0).float().mean()),
            "entry_row_len_p50": e50, "entry_row_len_p99": e99}


def kernel_split(fn, names, reps: int = 5, tries: int = 4) -> dict:
    """Device time and launches per call of fn (after a warm-up), over
    ``reps`` profiled calls: of each kernel whose profiler name contains
    one of ``names`` ({name: [ms, launches]}), of those together
    (``ms``, ``launches``) and of every device event (``busy_ms``). The
    trace sometimes misses a session's first kernels, or all of them: a
    session is taken again (up to ``tries`` in all) until every such
    kernel shows a whole number of launches a call; ``complete`` says
    whether one did."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        mine = [e for e in events if any(n in e.key for n in names)]
        complete = bool(mine) and all(e.count % reps == 0 for e in mine)
        if complete:
            break
    split = {kernel_name(e.key): [e.self_device_time_total / 1e3 / reps,
                                  e.count / reps] for e in mine}
    return {"by_kernel": split, "ms": sum(v[0] for v in split.values()),
            "launches": sum(v[1] for v in split.values()),
            "busy_ms": sum(e.self_device_time_total
                           for e in events) / 1e3 / reps,
            "complete": complete, "sessions": attempt}


def scatter_call_line(c: dict, reps: int = 20) -> dict:
    """A kernel line of the weighted scatter on a captured call's inputs:
    bit-equal to its plain version and to a second run, its row
    statistics, its time (CUDA events) and its kernels' device time by
    name (kernel_split), beside the deterministic index_put_ and the
    atomic index_add_ on the premultiplied contributions, and its bound
    (idx, w and g read once, the table written once)."""
    import torch

    from animnerf_tpu_torch.ops.blend import (
        weighted_scatter_rows,
        weighted_scatter_rows_plain,
    )

    idx, w, g, V = c["idx"], c["w"], c["g"], c["num_rows"]
    B, K, N = idx.shape
    out = weighted_scatter_rows(idx, w, g, V)
    out2 = weighted_scatter_rows(idx, w, g, V)
    outp = weighted_scatter_rows_plain(idx, w, g, V)
    torch.cuda.synchronize()
    err = float((out - outp).abs().max())
    same = bool(torch.equal(out, outp))
    deterministic = bool(torch.equal(out, out2))
    check(same and deterministic, f"scatter ({B},{K},{N}): bit-equal to "
          f"plain {same} (max err {err}), to a second run {deterministic}")
    del out2, outp
    contrib = (w[:, :, None, :] * g[:, None]).permute(0, 1, 3, 2) \
        .reshape(-1, 16).contiguous()
    rows = (idx.long() + (torch.arange(B, device=idx.device)
                          * V)[:, None, None]).reshape(-1)
    flat = torch.zeros(B * V, 16, device=idx.device)
    line = dict(
        shape=f"idx/w ({B},{K},{N}) g ({B},16,{N}) -> ({B},{V},16)",
        **scatter_row_stats(idx, w, g, V), max_abs_err=err, tolerance=0.0,
        bit_equal_to_plain=same, deterministic=deterministic,
        ms=time_ms(lambda: weighted_scatter_rows(idx, w, g, V), reps),
        plain_ms=time_ms(lambda: weighted_scatter_rows_plain(idx, w, g, V),
                         3),
        kernels=kernel_split(lambda: weighted_scatter_rows(idx, w, g, V),
                             SCATTER_KERNEL_NAMES),
        bound_ms=B * (N * (K + K + 16) * 4 + V * 16 * 4) / PEAK_BYTES * 1e3,
        bound_by="bytes",
        library_ms=deterministic_scatter_ms(flat, rows, contrib, reps),
        library_call="index_put_(accumulate=True), deterministic algorithms",
        library_atomic_ms=time_ms(
            lambda: flat.zero_().index_add_(0, rows, contrib), reps))
    line["pct_of_bound"] = 100.0 * line["bound_ms"] / line["ms"]
    return line


def step_scatter_lines(calls: list) -> dict:
    """scatter_call_line on a training step's first scatter call (the
    coarse pass's), with the second (the fine pass's) under "fine"."""
    check(len(calls) == 2, f"a step made {len(calls)} scatter calls")
    line = scatter_call_line(calls[0])
    line["fine"] = scatter_call_line(calls[1])
    return line


def warp_blend_call_line(args: tuple, reps: int = 20) -> dict:
    """A kernel line of the warp-blend on a captured call's arguments:
    within 1e-4 of its plain version (every output), its time (CUDA
    events) and bound (inputs read once, outputs written once), the bytes
    of the gathered table rows (N * K * F * 4) as a field of their own,
    and, where the wrapper has it, the residual-free mode (``out`` only):
    its time, its own bound, and its ``out`` bit-equal to the full
    mode's."""
    import inspect

    import torch

    from animnerf_tpu_torch.ops.warp_blend import (
        warp_blend_fwd,
        warp_blend_fwd_plain,
    )

    rows, d, idx, table, num_lbs = args[:5]
    B, K, N = idx.shape
    F = table.shape[2]
    out = warp_blend_fwd(*args)
    outp = warp_blend_fwd_plain(*args)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, outp))
    tol = 1e-4  # f32 blend; nvcc contracts the blend sums into FMAs
    check(err <= tol, f"warp_blend ({B},{K},{N}) F={F}: max err {err}")
    del outp
    in_bytes = (3 * N + 2 * K * N) * B * 4 + table.numel() * 4
    line = dict(
        shape=f"rows ({B},8,{N}) knn ({B},{K},{N}) table "
        f"{tuple(table.shape)}", max_abs_err=err, tolerance=tol,
        gathered_bytes=B * N * K * F * 4,
        ms=time_ms(lambda: warp_blend_fwd(*args), reps),
        plain_ms=time_ms(lambda: warp_blend_fwd_plain(*args), 3),
        kernels=kernel_split(lambda: warp_blend_fwd(*args),
                             WARP_BLEND_KERNEL_NAMES),
        bound_ms=max((in_bytes + B * N * (8 + K + 16) * 4) / PEAK_BYTES,
                     B * N * (K * (3 * num_lbs + 40) + 100) / PEAK_F32)
        * 1e3, bound_by="bytes", library_ms=None)
    line["pct_of_bound"] = 100.0 * line["bound_ms"] / line["ms"]
    if "residuals" in inspect.signature(warp_blend_fwd).parameters:
        o = warp_blend_fwd(*args, residuals=False)[0]
        same = bool(torch.equal(o, out[0]))
        check(same, f"warp_blend ({B},{K},{N}) F={F}: the residual-free "
              "out differs from the full mode's")
        line.update(
            out_only_bit_equal=same,
            out_only_ms=time_ms(
                lambda: warp_blend_fwd(*args, residuals=False), reps),
            out_only_bound_ms=(in_bytes + B * N * 8 * 4) / PEAK_BYTES * 1e3)
    return line


def exact_calls(calls: list) -> dict:
    """Kernel 9's launches and points per launch among captured kNN calls
    (those above the packed kernels' 8192 vertices)."""
    from animnerf_tpu_torch.ops.knn_kernel import MAX_VERTS

    n = [c["N"] for c in calls if c["V"] > MAX_VERTS]
    return {"knn_exact_launches": len(n), "knn_exact_points": n,
            "knn_exact_points_per_launch": float(np.mean(n)) if n else 0.0}


def wgrad_sass(funcs: dict) -> dict:
    """Instruction counts of the bf16 weight-gradient kernel's SASS: its
    products (HGMMA, wgmma), tensor loads (UTMALDG) and local-memory
    spills (STL / LDL)."""
    ins = [t for name, f in funcs.items() if "mlp_wgrad_bf16" in name
           for _, t in f]
    return {op: sum(t.split()[0].split(".")[0] == op for t in ins)
            for op in ("HGMMA", "UTMALDG", "UBLKCP", "STL", "LDL")}


def knn_bound_ms(pairs: float, nbytes: float) -> float:
    """Kernels 1 and 8: KNN_PAIR_OPS non-FMA f32 operations per swept
    (point, vertex) pair over their peak, or the bytes read and written
    once over the memory rate, the larger."""
    return max(KNN_PAIR_OPS * pairs / PEAK_F32_NONFMA,
               nbytes / PEAK_BYTES) * 1e3


def add_sweep_fields(line: dict, sass: dict, k: int, insert: str,
                     skip: bool = False) -> None:
    """A kernel 1 or 8 line's share of its bound, and its sweep's points
    per thread and SASS instructions per pair (sweep_sass's entry for
    (k, skip, insert))."""
    line["pct_of_bound"] = 100.0 * line["bound_ms"] / line["ms"]
    line.update(sass[(k, skip, insert)])


def deterministic_scatter_ms(flat, rows, contrib, reps: int) -> float:
    """The deterministic library scatter: ``index_put_`` with
    accumulate=True under ``torch.use_deterministic_algorithms(True)`` (a
    sort-based sum on CUDA; ``index_add_`` takes the same path there), on
    the premultiplied contributions."""
    import torch

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return time_ms(lambda: flat.zero_().index_put_(
            (rows,), contrib, accumulate=True), reps)
    finally:
        torch.use_deterministic_algorithms(was)


def kernel_lines(system, ctx, sass):
    """Check and time each serving kernel at the serving path's shapes
    (sass: sweep_sass of the built library)."""
    import torch

    from animnerf_tpu_torch.models.nerf import NeRFMLP
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
        bound_ms=knn_bound_ms(N * V, N * 12 + V * 12 + N * 32),
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
        out_only_ms=time_ms(lambda: warp_blend_fwd(*args, residuals=False),
                            reps), prev_ms=PREV_WARP_BLEND_MS[4],
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
        bound_ms=knn_bound_ms(N * V, N * 12 + V * 12 + N * 64),
        bound_by="operations", library_ms=None)
    d4, i4 = knn_packed(pts, verts, 4)
    torch.cuda.synchronize()
    same = bool(torch.equal(d4, d) and torch.equal(i4, i))
    check(same, "knn_packed K=4 differs from knn_top4")
    lines["knn_packed_k4"] = dict(
        shape=f"points (1,{N},3) verts (1,{V},3) K=4",
        max_abs_err=float((d4 - dp).abs().max()), tolerance=0.0,
        idx_mismatch=int((i4 != ip).sum()), bit_equal_to_knn_top4=same,
        ms=time_ms(lambda: knn_packed(pts, verts, 4), reps),
        plain_ms=time_ms(lambda: knn_packed_plain(pts, verts, 4), preps),
        bound_ms=lines["knn"]["bound_ms"], bound_by="operations",
        library_ms=None)
    for name, k, insert in (("knn", 4, "top4"), ("knn_packed", 8, "packed"),
                            ("knn_packed_k4", 4, "packed")):
        add_sweep_fields(lines[name], sass, k, insert)

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
        out_only_ms=time_ms(lambda: warp_blend_fwd(*args8, residuals=False),
                            reps), prev_ms=PREV_WARP_BLEND_MS[8],
        plain_ms=time_ms(lambda: warp_blend_fwd_plain(*args8), preps),
        bound_ms=max(wb8_bytes / PEAK_BYTES,
                     N * (8 * (3 * J + 40) + 100) / PEAK_F32) * 1e3,
        bound_by="bytes", library_ms=None)
    del d8, i8, dp8, ip8, table8, out8, outp8

    # -- fused MLP: canonical points with the scale512 weights, bf16, from
    # the weight image serving caches with the packed weights
    M = 1 << 21
    tv = ctx.verts_template[0]
    pick = torch.randint(0, tv.shape[0], (M,), generator=g, device=dev)
    xyz = tv[pick] + 0.05 * torch.randn(M, 3, generator=g, device=dev)
    xrows = torch.nn.functional.pad(xyz.t(), (0, 0, 0, 5))[None].contiguous()
    nerf = system.scene.nerf_fine
    ws, bs = nerf.packed()
    image = nerf.packed_image()
    o = fused_nerf_fwd(xrows, ws, bs, 10, "bfloat16", image)
    o2 = fused_nerf_fwd(xrows, ws, bs, 10, "bfloat16", image)
    op = fused_nerf_fwd_plain(xrows, ws, bs, 10, "bfloat16")
    torch.cuda.synchronize()
    deterministic = bool(torch.equal(o, o2))
    check(deterministic, "fused_mlp bf16: two launches differ")
    err, err_rgb, sig_excess = mlp_fwd_errors(o, op, "scale512 weights")
    # a narrower encoding (n_freqs 7: 45 rows, zero-padded to 64 columns)
    # on random weights from a seed, biases drawn too
    torch.manual_seed(7)
    mlp7 = NeRFMLP(7, "bfloat16").to(dev)
    for m in mlp7.children():
        torch.nn.init.normal_(m.bias, std=0.1)
    ws7, bs7 = mlp7.packed()
    x7 = xrows[..., :65536].contiguous()
    o7 = fused_nerf_fwd(x7, ws7, bs7, 7, "bfloat16", mlp7.packed_image())
    op7 = fused_nerf_fwd_plain(x7, ws7, bs7, 7, "bfloat16")
    torch.cuda.synchronize()
    err7, _, _ = mlp_fwd_errors(o7, op7, "n_freqs 7")
    del o2, o7, op7
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
    bound = max(flops / PEAK_BF16,
                (M * (12 + 32) + sum(w.numel() * 2 for w in ws))
                / PEAK_BYTES) * 1e3
    ms = time_ms(lambda: fused_nerf_fwd(xrows, ws, bs, 10, "bfloat16", image),
                 reps)
    lines["fused_mlp"] = dict(
        shape=f"rows (1,8,{M}) bf16 weights 13 packed", max_abs_err=err,
        max_abs_err_rgb=err_rgb, sigma_excess_over_tolerance=sig_excess,
        tolerance="rgb 2e-2; sigma 3e-2 + 2e-2*|sigma|; rows 4..7 zero",
        deterministic=deterministic, n_freqs7_max_abs_err=err7,
        n_freqs7_shape="rows (1,8,65536), random weights",
        f32_rel_err=err32, ms=ms, prev_ms=PREV_FWD_MS,
        plain_ms=time_ms(lambda: fused_nerf_fwd_plain(xrows, ws, bs, 10,
                                                    "bfloat16"), preps),
        bound_ms=bound, pct_of_bound=100.0 * bound / ms,
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


def kernel_lines_train(dev, sass):
    """Check and time the training step's kernels at its shapes: the kNN
    with the tile skip on Morton-ordered points of 16 frames (32,768
    coarse survivors each, as a 16 x 1024-ray step keeps), the weighted
    scatter of those neighbours, and the MLP backward over 2^20 points
    (the fine MLP's coarse survivors + fine samples) in bf16, and over
    2^16 points in f32 (sass: sweep_sass of the built library)."""
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
        weight_image,
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
        max_abs_err=err, tolerance=0.0, idx_mismatch=mism,
        bit_equal_to_no_skip=bit_equal,
        warp_tiles_swept=swept, warp_tiles_skipped=skipped,
        skipped_share=1.0 - swept_share,
        ms=time_ms(lambda: knn_top4(pts, verts, tile_skip=True), reps),
        ms_no_skip=time_ms(lambda: knn_top4(pts, verts), reps),
        plain_ms=time_ms(lambda: knn_top4_plain(pts, verts), preps),
        # the pairs this run's skip left to sweep
        bound_ms=knn_bound_ms(B * N * V * swept_share,
                              B * (N * 12 + V * 12 + N * 32)),
        bound_by="operations", library_ms=None)
    add_sweep_fields(lines["knn_tile_skip"], sass, 4, "top4", skip=True)

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
        # every kernel the wrapper launches
        ms=time_ms(lambda: weighted_scatter_rows(i1, w, gr, V), reps),
        prev_ms=PREV_SCATTER_MS[4],
        kernels=kernel_split(lambda: weighted_scatter_rows(i1, w, gr, V),
                             SCATTER_KERNEL_NAMES),
        plain_ms=time_ms(lambda: weighted_scatter_rows_plain(i1, w, gr, V),
                         preps),
        # idx, w and g read once, the table written once
        bound_ms=B * (N * (4 + 4 + 16) * 4 + V * 16 * 4) / PEAK_BYTES * 1e3,
        bound_by="bytes",
        # the same function, deterministic; and the atomic index_add_
        library_ms=deterministic_scatter_ms(flat, rows, contrib, reps),
        library_call="index_put_(accumulate=True), deterministic algorithms",
        library_atomic_ms=time_ms(
            lambda: flat.zero_().index_add_(0, rows, contrib), reps))

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
        prev_ms=PREV_SCATTER_MS[8],
        kernels=kernel_split(lambda: weighted_scatter_rows(i8, w8, gr, V),
                             SCATTER_KERNEL_NAMES),
        plain_ms=time_ms(lambda: weighted_scatter_rows_plain(i8, w8, gr, V),
                         preps),
        bound_ms=B * (N * (8 + 8 + 16) * 4 + V * 16 * 4) / PEAK_BYTES * 1e3,
        bound_by="bytes",
        library_ms=deterministic_scatter_ms(flat, rows8, contrib8, reps),
        library_call="index_put_(accumulate=True), deterministic algorithms",
        library_atomic_ms=time_ms(
            lambda: flat.zero_().index_add_(0, rows8, contrib8), reps))
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
            # (the weight image prebuilt, as the training step passes it:
            # the call then launches only the backward's own kernels, which
            # must account for its whole device-busy time)
            image = weight_image(ws)
            split = split_bwd_profile(
                lambda: fused_nerf_bwd(xyz, ws, bs, dout, 10, dt, image))
            split["accounted_share"] = ((split["main_ms"] + split["wgrad_ms"])
                                        / split["busy_ms"])
            check(abs(split["accounted_share"] - 1.0) <= 0.02,
                  f"fused_mlp_bwd: main + rest {split['main_ms']} + "
                  f"{split['wgrad_ms']} ms of {split['busy_ms']} ms busy")
            # the rest's own bound: the products dW_l = G_l^T H_l (the
            # forward's flops) or one read of the scratch and the head
            # cotangents (9,856 + 16 B a point), the larger
            split.update(
                bound_main_ms=max(2.0 * fwd_flops * M / peak,
                                  M * 9856 / PEAK_BYTES) * 1e3,
                bound_wgrad_ms=max(fwd_flops * M / peak,
                                   M * (9856 + 16) / PEAK_BYTES) * 1e3,
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
            bound_by="operations", **split, **(dict(
                library_ms=time_ms(lambda: library_mlp_vjp(state, xyz, dout),
                                   3, warmup=1),
                library_call="library_mlp_vjp: F.linear forward in bf16 "
                             "(cuBLAS) + torch.autograd.grad")
                if dt == "bfloat16" else dict(library_ms=None)))
        del a, a2, b
    return lines


def library_mlp_vjp(state: dict, xyz, dout):
    """One call of the MLP's VJP as PyTorch's own ops: the forward as
    ``torch.nn.functional.linear`` on point-major bf16 activations
    (cuBLAS; the sigma and rgb heads in f32), then ``torch.autograd.grad``
    to the coordinates and every weight and bias. The library yardstick of
    the fused backward; its rounding points are cuBLAS's, not the TPU
    kernel's."""
    import torch

    from animnerf_tpu_torch.models.embedding import positional_encoding

    bf = torch.bfloat16
    names = [f"xyz_{i}" for i in range(8)] + ["sigma", "xyz_final", "dir_0",
                                              "rgb"]
    p = {n: (state[f"{n}.weight"].detach().requires_grad_(),
             state[f"{n}.bias"].detach().requires_grad_()) for n in names}
    x = xyz[0, 0:3].t().detach().requires_grad_()
    enc = positional_encoding(x, 10).to(bf)

    def lin(h, n, dt=bf):
        return torch.nn.functional.linear(h.to(dt), p[n][0].to(dt),
                                          p[n][1].to(dt))

    h = enc
    for i in range(8):
        h = torch.relu(lin(torch.cat([enc, h], -1) if i == 4 else h,
                           f"xyz_{i}"))
    hd = torch.relu(lin(lin(h, "xyz_final"), "dir_0"))
    out = torch.cat([torch.sigmoid(lin(hd, "rgb", torch.float32)),
                     lin(h, "sigma", torch.float32)], -1)
    return torch.autograd.grad(out, [x] + [t for n in names for t in p[n]],
                               dout[0, 0:4].t())


def kernel_line_wgrad(dev, sass: dict):
    """The bf16 MLP backward's weight-gradient pass alone (the C entry
    animnerf_mlp_wgrad: mlp_wgrad_prep, mlp_wgrad_bf16, reduce_splits)
    through fused_nerf_wgrad, on scratches the main kernel wrote: a full
    chunk (BWD_CHUNK points), 128 points, and 131,072 - 37 points of a
    131,072-point chunk (a ragged edge: the rows past it read as zeros).
    Each against wgrad_from_scratch_plain in f64: rel-L2 of every gradient
    <= 1e-4 (the products of bf16 operands are exact, the f32 sums run in
    another order), bit-equal across two runs and, where fused_nerf_bwd ran
    the pass over the same rows, equal to its gradients. It is the probe of
    the pass's MN-major wgmma descriptors: an error there is garbage and
    fails it. Timed at the full chunk, per 2^20 points; the library
    yardstick is the same products and sums as PyTorch calls on the
    point-major arrays (sass: library_sass of the built library)."""
    import torch

    from animnerf_tpu_torch.models.nerf import NeRFMLP
    from animnerf_tpu_torch.ops.fused_mlp import (
        BWD_CHUNK,
        BWD_E,
        HEAD_COLS,
        WGRAD_LAYERS,
        fused_nerf_bwd_buffers,
        fused_nerf_wgrad,
        pack_params,
        scratch_views,
        weight_image,
        wgrad_from_scratch_plain,
    )

    torch.manual_seed(0)
    mlp = NeRFMLP(10, "float32").to(dev)
    ws, bs = pack_params({k: v.detach() for k, v in mlp.state_dict().items()},
                         10, "bfloat16")
    image = weight_image(ws)
    sizes = [t.numel() for t in ws + bs]
    names = [f"dW{i}" for i in range(13)] + [f"db{i}" for i in range(13)]
    g = torch.Generator(device=dev).manual_seed(5)
    tol = 1e-4
    cases, line = [], {}
    for M, rows in ((BWD_CHUNK, BWD_CHUNK), (128, 128),
                    (131072, 131072 - 37)):
        xyz = torch.zeros(1, 8, M, device=dev)
        xyz[0, :3] = 0.3 * torch.randn(3, M, generator=g, device=dev)
        dout = torch.zeros(1, 8, M, device=dev)
        dout[0, :4] = 1e-3 * torch.randn(4, M, generator=g, device=dev)
        _, grads, scratch, heads, chunk = fused_nerf_bwd_buffers(
            xyz, ws, bs, dout, 10, "bfloat16", image)
        a = fused_nerf_wgrad(scratch, heads, rows, chunk)
        a2 = fused_nerf_wgrad(scratch, heads, rows, chunk)
        ref = wgrad_from_scratch_plain(scratch, heads, rows, chunk,
                                       torch.float64)
        torch.cuda.synchronize()
        rel, o = {}, 0
        for n, k in zip(names, sizes):
            x, y = a[o:o + k].double(), ref[o:o + k]
            rel[n] = float((x - y).norm() / max(float(y.norm()), 1e-30))
            o += k
        case = dict(points=rows, chunk=chunk, max_rel_l2=max(rel.values()),
                    worst=max(rel, key=rel.get),
                    max_abs_err=float((a[:o].double() - ref[:o]).abs().max()),
                    deterministic=bool(torch.equal(a, a2)),
                    equal_to_bwd=bool(torch.equal(a, grads))
                    if rows == M else None)
        cases.append(case)
        check(case["max_rel_l2"] <= tol and case["deterministic"]
              and case["equal_to_bwd"] is not False,
              f"fused_mlp_wgrad at {rows} points: {case} {rel}")
        if M == BWD_CHUNK:
            scale = (1 << 20) / rows
            H, G = scratch_views(scratch, chunk, BWD_E)
            hc = heads[:chunk * HEAD_COLS].view(chunk, HEAD_COLS)
            d_sig_b = hc[:, 3:4].to(torch.bfloat16)
            d_rgb_b = hc[:, 0:3].to(torch.bfloat16)

            def library():
                for _, gi, hi in WGRAD_LAYERS:
                    torch.matmul(G[gi].t(), H[hi])
                torch.matmul(d_sig_b.t(), H[8])
                torch.matmul(d_rgb_b.t(), H[10])
                for gi in range(len(G)):
                    G[gi].sum(0, dtype=torch.float32)
                hc.sum(0)

            # the products dW_l = G_l^T H_l and the heads, 2 flops a
            # multiply-add, or one read of the scratch and the head
            # cotangents (9,872 B a point), the larger
            flops = 2.0 * (sum(ws[l].numel() for l, _, _ in WGRAD_LAYERS)
                           + 256 + 3 * 128) * (1 << 20)
            bound = max(flops / PEAK_BF16,
                        (1 << 20) * 9872 / PEAK_BYTES) * 1e3
            ms = time_ms(lambda: fused_nerf_wgrad(scratch, heads, rows,
                                                  chunk), 10) * scale
            line = dict(
                shape=f"scratch of {rows} points (bf16, 9,856 B a point) + "
                      f"head cotangents (16 B), from the main kernel",
                max_abs_err=case["max_abs_err"], ms=ms,
                ms_chunk=ms / scale, plain_ms=time_ms(
                    lambda: wgrad_from_scratch_plain(scratch, heads, rows,
                                                     chunk), 3,
                    warmup=1) * scale,
                bound_ms=bound, bound_by="bytes", pct_of_bound=bound / ms,
                achieved_tb_s=(1 << 20) * 9872 / (ms / 1e3) / 1e12,
                prev_ms=PREV_WGRAD_MS,
                library_ms=time_ms(library, 10) * scale,
                library_call="torch.matmul(G_l.t(), H_l) in bf16 for the 11 "
                             "layers, the two head products on the bf16 "
                             "head cotangents, G.sum(0, f32) for the 10 G "
                             "arrays and the f32 head sums, on the same "
                             "point-major arrays",
                ms_basis="per 2^20 points, from the chunk's time")
        del scratch, heads, grads, a, a2, ref
    torch.cuda.empty_cache()
    hg = wgrad_sass(sass)
    check(hg["HGMMA"] > 0, f"no wgmma in mlp_wgrad_bf16's SASS: {hg}")
    line.update(tolerance=dict(rel_l2=tol), max_rel_l2=max(
        c["max_rel_l2"] for c in cases), deterministic=all(
        c["deterministic"] for c in cases), cases=cases, sass=hg)
    return line


EDGE_POINTS = (1 << 20) - 37  # a whole number of no block's points


def kernel_lines_edge(dev):
    """Kernels 1 and 8 at the shapes their sweep's tiling stresses:
    N = 2^20 - 37 points, V in {K, 1025, 8192} vertices (one padded tile;
    one real row in the last tile; the index field's limit), K in {1, 4,
    8, 16}, kernel 1 (K = 4) with and without its tile skip; seeded clouds
    (normal, 0.3 m) and points near them (0.05 m). Each output bit-equal
    to its plain version, and the rows kernel's rows and visiting order
    (both layouts) to ``vertex_rows_plain``'s."""
    import torch

    from animnerf_tpu_torch.ops.knn_kernel import (
        knn_packed,
        knn_packed_plain,
        knn_top4,
        vertex_rows,
        vertex_rows_plain,
    )

    g = torch.Generator(device=dev).manual_seed(5)
    N = EDGE_POINTS
    lines = {}
    for V in (1, 4, 8, 16, 1025, 8192):
        verts = 0.3 * torch.randn(1, V, 3, generator=g, device=dev)
        pick = torch.randint(0, V, (N,), generator=g, device=dev)
        pts = (verts[0, pick]
               + 0.05 * torch.randn(N, 3, generator=g, device=dev))[None]
        rows_equal = all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for st in (True, False)
            for a, b in zip(vertex_rows(verts, st),
                            vertex_rows_plain(verts, st)))
        check(rows_equal, f"edge V={V}: rows kernel differs from plain")
        for K in (1, 4, 8, 16):
            if V != K and V < 1025:
                continue
            dp, ip = knn_packed_plain(pts, verts, K,
                                      max_elems=PLAIN_MAX_ELEMS)
            runs = [("knn_packed", lambda: knn_packed(pts, verts, K))]
            if K == 4:
                runs += [("knn", lambda: knn_top4(pts, verts)),
                         ("knn_tile_skip",
                          lambda: knn_top4(pts, verts, tile_skip=True))]
            for kname, fn in runs:
                d, i = fn()
                torch.cuda.synchronize()
                mism = int((i != ip).sum())
                err = float((d - dp).abs().max())
                check(mism == 0 and err == 0.0,
                      f"edge {kname} K={K} V={V}: {mism} index mismatches, "
                      f"max err {err}")
                lines[f"{kname}_k{K}_v{V}"] = dict(
                    shape=f"points (1,{N},3) verts (1,{V},3) K={K}",
                    max_abs_err=err, tolerance=0.0, idx_mismatch=mism,
                    rows_bit_equal=rows_equal)
    return lines


def kernel_lines_edge_scatter_warp(dev):
    """Kernels 5 and 2 at the shapes their designs stress. The scatter at
    K in {1, 4, 8, 16} with one radix pass (B V = 300), two (B V = 13,780,
    N = 20,011: a ragged last tile) and three (B V = 275,600 > 2^18), half
    of the first neighbours on one row, zero weights and zero cotangent
    columns: each bit-equal to its plain version and to a second run. The
    warp-blend at K in {1, 4, 8, 16} on each family's row (LBS part 5, 16,
    24, 52, 55: FLAME, MANO, SMPL, SMPL-H, SMPL-X; padded to 4 floats where
    it is not a multiple) and on an SMPL table 4 bytes off 16-byte
    alignment (padded too), one-hot LBS columns so that several neighbours
    blend: within 1e-4 of its plain version, the residual-free out
    bit-equal to the full mode's."""
    import torch

    from animnerf_tpu_torch.ops.blend import (
        radix_passes,
        weighted_scatter_rows,
        weighted_scatter_rows_plain,
    )
    from animnerf_tpu_torch.ops.warp_blend import (
        warp_blend_fwd,
        warp_blend_fwd_plain,
    )

    g = torch.Generator(device=dev).manual_seed(9)
    lines = {}
    for B, V, N in ((1, 300, 4099), (2, 6890, 20011), (40, 6890, 3001)):
        for K in (1, 4, 8, 16):
            idx = torch.randint(0, V, (B, K, N), generator=g, device=dev,
                                dtype=torch.int32)
            idx[:, 0, ::2] = V // 3
            w = torch.rand(B, K, N, generator=g, device=dev)
            w[:, K // 2:, ::3] = 0.0
            gr = torch.randn(B, 16, N, generator=g, device=dev)
            gr[:, :, ::7] = 0.0
            out = weighted_scatter_rows(idx, w, gr, V)
            out2 = weighted_scatter_rows(idx, w, gr, V)
            outp = weighted_scatter_rows_plain(idx, w, gr, V)
            torch.cuda.synchronize()
            same, det = bool(torch.equal(out, outp)), bool(
                torch.equal(out, out2))
            err = float((out - outp).abs().max())
            check(same and det, f"edge scatter K={K} B={B} V={V} N={N}: "
                  f"bit-equal {same} (max err {err}), deterministic {det}")
            lines[f"scatter_k{K}_b{B}_v{V}"] = dict(
                shape=f"idx/w ({B},{K},{N}) -> ({B},{V},16)",
                radix_passes=radix_passes(B * V), max_abs_err=err,
                tolerance=0.0, bit_equal_to_plain=same, deterministic=det)
    N, V = 5003, 500
    for num_lbs, aligned in ((5, True), (16, True), (24, True), (52, True),
                             (55, True), (24, False)):
        F = num_lbs + 16
        flat = torch.randn(V * F + 1, generator=g, device=dev)
        table = (flat[:-1] if aligned else flat[1:]).view(1, V, F)
        bone = torch.randint(0, min(num_lbs, 3), (V,), generator=g,
                             device=dev)
        table[0, :, :num_lbs] = torch.nn.functional.one_hot(
            bone, num_lbs).float()
        for K in (1, 4, 8, 16):
            idx = torch.randint(0, V, (1, K, N), generator=g, device=dev,
                                dtype=torch.int32)
            d = torch.rand(1, K, N, generator=g, device=dev).sort(1)[0]
            rows = torch.zeros(1, 8, N, device=dev)
            rows[0, :3] = torch.randn(3, N, generator=g, device=dev)
            args = (rows, d.contiguous(), idx, table, num_lbs, 0.1, 0.9)
            out = warp_blend_fwd(*args)
            outp = warp_blend_fwd_plain(*args)
            o = warp_blend_fwd(*args, residuals=False)[0]
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(out, outp))
            same = bool(torch.equal(o, out[0]))
            check(err <= 1e-4 and same, f"edge warp_blend K={K} "
                  f"num_lbs={num_lbs} aligned={aligned}: max err {err}, "
                  f"residual-free out bit-equal {same}")
            lines[f"warp_blend_k{K}_f{F}{'' if aligned else '_off16'}"] = \
                dict(shape=f"knn (1,{K},{N}) table (1,{V},{F})",
                     max_abs_err=err, tolerance=1e-4,
                     out_only_bit_equal=same)
    return lines


def morton_sorted(x):
    """(1, n, 3) points or vertices in Morton order (the order of the
    training step's rows and of the warp's cloud)."""
    import torch

    from animnerf_tpu_torch.ops.warp_blend import morton_codes

    order = torch.argsort(morton_codes(x), dim=1, stable=True)
    return torch.gather(x, 1, order[..., None].expand(-1, -1, 3)).contiguous()


def kernel_lines_edge_exact(dev, exact: dict):
    """Kernel 9 at the shapes its tiling stresses: N = 2^20 - 37 points,
    V in {K, 513, 8193, 10475} (one padded tile; one real vertex in the
    last tile; just above the packed kernels' limit; SMPL-X), K in {1, 4,
    8, 16}, seeded Morton-sorted clouds (normal, 0.3 m) and Morton-ordered
    points near them (0.05 m), so that the cull skips; then a tie-rich
    cloud, vertices and points on a 1/64 grid, at K = 4 and 16. Each
    output, with and without the cull, bit-equal to knn_exact_plain, and
    the rows kernel's rows and boxes to exact_rows_plain's."""
    import torch

    from animnerf_tpu_torch.ops.knn_kernel import exact_rows, exact_rows_plain

    g = torch.Generator(device=dev).manual_seed(6)
    N = EDGE_POINTS
    clouds = []
    for V in (1, 4, 8, 16, 513, 8193, 10475):
        verts = morton_sorted(0.3 * torch.randn(1, V, 3, generator=g,
                                                device=dev))
        pick = torch.randint(0, V, (N,), generator=g, device=dev)
        pts = morton_sorted((verts[0, pick] + 0.05 * torch.randn(
            N, 3, generator=g, device=dev))[None])
        ks = [k for k in (1, 4, 8, 16) if k == V or V > 16]
        clouds.append(("normal", V, verts, pts, ks))
    grid_v = morton_sorted(torch.randint(-48, 49, (1, 10475, 3), generator=g,
                                         device=dev).float() / 64)
    grid_p = morton_sorted(torch.randint(-56, 57, (1, N, 3), generator=g,
                                         device=dev).float() / 64)
    clouds.append(("grid", 10475, grid_v, grid_p, [4, 16]))
    lines = {}
    for cloud, V, verts, pts, ks in clouds:
        rows_equal = all(torch.equal(a, b) for a, b in
                         zip(exact_rows(verts), exact_rows_plain(verts)))
        check(rows_equal, f"edge V={V}: exact rows kernel differs from plain")
        for K in ks:
            lines[f"knn_exact_{cloud}_k{K}_v{V}"] = dict(
                shape=f"points (1,{N},3) verts (1,{V},3) K={K}",
                **exact_check(pts, verts, K), rows_bit_equal=rows_equal,
                **exact[K])
    return lines


SMPLX_KNN_POINTS = 1 << 20
SMPLX_MIN_DIST_POINTS = 1 << 22


def kernel_lines_smplx(dev, exact: dict):
    """Check and time the SMPL-X kernels at their main-path widths against
    the posed seed-0 SMPL-X cloud (V=10475, Morton order as the warp sees
    it): the exact kNN over 2^20 points near the cloud in random order
    (exact_line: with and without its cull, which skips little on such
    points) at K = 4 and 8, and the nearest-vertex distance over 2^22
    points (a slab of the serving pre-pass). Both versions round every
    operation alike, follow the same top-k rule and take IEEE square
    roots, so the outputs must be bit-equal. Neither has a one-call
    PyTorch counterpart (cdist then topk / amin is two calls), so
    library_ms is null."""
    import torch

    from animnerf_tpu_torch.models.warp import prepare_frame
    from animnerf_tpu_torch.ops.knn import (
        min_vertex_distance,
        min_vertex_distance_plain,
    )

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
        lines[name] = dict(exact_line(pts, verts, k, exact),
                           prev_ms=PREV_EXACT_MS[k])

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
    "fused_mlp_wgrad": ("animnerf_tpu_torch/csrc/mlp_wgrad.cu",
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
    "knn_exact_nocull": ("animnerf_tpu_torch/csrc/knn_exact.cu",
                         "animnerf_tpu/ops/knn_pallas.py:35"),
    "knn_exact_view": ("animnerf_tpu_torch/csrc/knn_exact.cu",
                       "animnerf_tpu/ops/knn_pallas.py:35"),
    "knn_exact_view_k8": ("animnerf_tpu_torch/csrc/knn_exact.cu",
                          "animnerf_tpu/ops/knn_pallas.py:35"),
    "warp_blend_k8": ("animnerf_tpu_torch/csrc/warp_blend.cu",
                      "animnerf_tpu/ops/warp_blend.py:48"),
    "scatter_k8": ("animnerf_tpu_torch/csrc/scatter.cu",
                   "animnerf_tpu/ops/blend.py:59"),
    # kernels 5 and 2 on the inputs the main paths give them: a training
    # step's scatter calls (SMPL, k_neigh 8), a view's first warp-blend
    # call (SMPL, SMPL-X, k_neigh 8)
    "scatter_step": ("animnerf_tpu_torch/csrc/scatter.cu",
                     "animnerf_tpu/ops/blend.py:59"),
    "scatter_step_k8": ("animnerf_tpu_torch/csrc/scatter.cu",
                        "animnerf_tpu/ops/blend.py:59"),
    "warp_blend_view": ("animnerf_tpu_torch/csrc/warp_blend.cu",
                        "animnerf_tpu/ops/warp_blend.py:48"),
    "warp_blend_smplx": ("animnerf_tpu_torch/csrc/warp_blend.cu",
                         "animnerf_tpu/ops/warp_blend.py:48"),
    "warp_blend_view_k8": ("animnerf_tpu_torch/csrc/warp_blend.cu",
                           "animnerf_tpu/ops/warp_blend.py:48"),
    "knn_mxu": ("animnerf_tpu_torch/csrc/knn_mxu.cu",
                "tools/bench_knn.py:29"),
    "knn_mxu_default": ("animnerf_tpu_torch/csrc/knn_mxu.cu",
                        "tools/bench_knn.py:29"),
    # the all-far skip (far2 > 0): its far pass (the bound of
    # _knn_kernel, :69-81, and its twins), then kernels 1, 8, 9 with it
    "knn_far": ("animnerf_tpu_torch/csrc/knn_far.cu",
                "animnerf_tpu/ops/knn_pallas.py:69"),
    "knn_far2": ("animnerf_tpu_torch/csrc/knn.cu",
                 "animnerf_tpu/ops/knn_pallas.py:268"),
    "knn_tile_skip_far2": ("animnerf_tpu_torch/csrc/knn.cu",
                           "animnerf_tpu/ops/knn_pallas.py:268"),
    "knn_packed_far2": ("animnerf_tpu_torch/csrc/knn_packed.cu",
                        "animnerf_tpu/ops/knn_pallas.py:161"),
    "knn_exact_far2": ("animnerf_tpu_torch/csrc/knn_exact.cu",
                       "animnerf_tpu/ops/knn_pallas.py:35"),
}
SERVE_KERNELS = ("knn", "warp_blend", "fused_mlp", "permute_lanes")
K8_SERVE_KERNELS = ("knn_packed", "warp_blend", "fused_mlp", "permute_lanes")
K8_TRAIN_KERNELS = ("knn_packed", "warp_blend", "scatter", "fused_mlp",
                    "fused_mlp_bwd", "fused_mlp_wgrad", "permute_lanes")
TRAIN_KERNELS = ("knn", "knn_tile_skip", "warp_blend", "scatter",
                 "fused_mlp", "fused_mlp_bwd", "fused_mlp_wgrad",
                 "permute_lanes")
SMPLX_SERVE_KERNELS = ("min_dist", "knn_exact", "knn_exact_cull",
                       "warp_blend", "fused_mlp", "permute_lanes")
SMPLX_TRAIN_KERNELS = ("knn_exact", "knn_exact_cull", "warp_blend",
                       "scatter", "fused_mlp", "fused_mlp_bwd",
                       "fused_mlp_wgrad", "permute_lanes")


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
    fwd = sum(e.self_device_time_total for e in events
              if "mlp_fwd_bf16" in e.key) / 1e3
    knn = sum(e.self_device_time_total for e in events
              if any(k in e.key for k in KNN_KERNEL_NAMES)) / 1e3
    exact = [e for e in events if "knn_exact_kernel" in e.key]
    exact_rows = sum(e.self_device_time_total for e in events
                     if "knn_exact_rows" in e.key) / 1e3
    far = [e for e in events if "knn_far_kernel" in e.key]
    scat = [e for e in events if any(k in e.key
                                      for k in SCATTER_KERNEL_NAMES)]
    wb = [e for e in events if any(k in e.key
                                    for k in WARP_BLEND_KERNEL_NAMES)]
    return {f"{what}_ms_profiled": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "mlp_fwd_ms": fwd, "mlp_fwd_share_of_busy": fwd / max(busy, 1e-9),
            "knn_ms": knn, "knn_share_of_busy": knn / max(busy, 1e-9),
            "knn_exact_ms": sum(e.self_device_time_total
                                for e in exact) / 1e3,
            "knn_exact_rows_ms": exact_rows,
            "knn_exact_launches": sum(e.count for e in exact),
            "knn_far_ms": sum(e.self_device_time_total for e in far) / 1e3,
            "knn_far_launches": sum(e.count for e in far),
            "scatter_ms": sum(e.self_device_time_total for e in scat) / 1e3,
            "scatter_launches": sum(e.count for e in scat),
            "scatter_by_kernel": {kernel_name(e.key):
                                  [e.self_device_time_total / 1e3, e.count]
                                  for e in scat},
            "warp_blend_ms": sum(e.self_device_time_total for e in wb) / 1e3,
            "warp_blend_launches": sum(e.count for e in wb),
            "mlp_bwd_main_ms": split["main_ms"],
            "mlp_bwd_wgrad_ms": split["wgrad_ms"],
            "mlp_bwd_launches": split["main_launches"]
            + split["rest_launches"],
            "mlp_bwd_main_launches": split["main_launches"],
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in events[:15]]}


# the MLP backward's kernels other than its main kernel: the bf16 weight-
# gradient pass (mlp_wgrad_prep, mlp_wgrad_bf16), the split reduction and
# the f32 path's weight-gradient, head and bias kernels
BWD_REST_NAMES = ("mlp_wgrad", "reduce_splits", "wgrad_f32", "wgrad_heads",
                  "bias_sums")


def bwd_split(events) -> dict:
    """Device ms and launches of the MLP backward's main kernel and of its
    other kernels (BWD_REST_NAMES) among profiler events."""
    main = [e for e in events if "mlp_bwd_main" in e.key]
    rest = [e for e in events if any(k in e.key for k in BWD_REST_NAMES)]
    return {"main_ms": sum(e.self_device_time_total for e in main) / 1e3,
            "wgrad_ms": sum(e.self_device_time_total for e in rest) / 1e3,
            "main_launches": sum(e.count for e in main),
            "rest_launches": sum(e.count for e in rest)}


def split_bwd_profile(fn) -> dict:
    """bwd_split over one profiled call of fn (after a warm-up), with the
    call's device-busy time (every device event)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    split = bwd_split(events)
    split["busy_ms"] = sum(e.self_device_time_total for e in events) / 1e3
    return split


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


def view_fn(system, bp, tmpl, angle, H=512, W=512, prepass="boxes"):
    """A function that renders turntable view ``angle`` through
    ``Renderer.render_stream``."""
    from animnerf_tpu_torch.render.inference import (
        Renderer,
        turntable_rotation,
    )

    renderer = Renderer(system, prepass=prepass)
    frame = dict(body_params=bp, body_tmpl=tmpl, rays=frame_rays(H, W),
                 P=turntable_rotation(angle, 64), img_wh=(W, H))

    def view():
        for _ in renderer.render_stream([frame]):
            pass

    return view


# the SMPL-X view's two profiles: busy times within this ratio
PROFILE_SPREAD = 1.10


def smplx_serve(angles):
    """The SMPL-X turntable with the exact pre-pass (launches: kernel 9
    with its cull on every call), two profiled views of angles[0] (their
    device-busy times within PROFILE_SPREAD), the kNN calls of one more
    (captured with their points) and the warp-blend calls of another (the
    first with its arguments), then the same views with the box pre-pass:
    the two images agree."""
    system = smplx_system()
    bp, tmpl = smplx_params(1, 1), smplx_params(1, 2, zero_transl=True)
    views, launches, _, imgs = render_turntable(
        system, bp, tmpl, angles, prepass="exact", profile=False)
    check(all(launches[k] > 0 for k in SMPLX_SERVE_KERNELS)
          and launches["knn_exact_cull"] == launches["knn_exact"]
          and launches["knn"] == launches["knn_packed"] == 0,
          f"SMPL-X serving launched the wrong kernels: {launches}")
    view = view_fn(system, bp, tmpl, angles[0], prepass="exact")
    view()  # the new renderer's first view
    profs = [profile_call(view, "view") for _ in range(2)]
    busy = [p["device_busy_ms"] for p in profs]
    check(max(busy) <= PROFILE_SPREAD * min(busy),
          f"the SMPL-X view's two profiles disagree: busy {busy} ms")
    calls = capture_knn(view, keep=True)
    wcalls = capture_warp_blend(view)  # kernel 2's first call, kept
    bviews, _, _, bimgs = render_turntable(system, bp, tmpl, angles,
                                           prepass="boxes", profile=False)
    # both pre-passes are exact end to end: a kept sample that is not
    # valid gets the outside-shell sigma, and every kernel works per point
    agree = max(float(np.abs(a - b).max()) for a, b in zip(imgs, bimgs))
    check(agree <= 1e-5, f"exact vs boxes pre-pass images: {agree}")
    return views, launches, profs, bviews, agree, calls, wcalls


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
                B: int = 16, R: int = 1024, capture: bool = False,
                scatter: bool = False):
    """The bench.py step: warm-up, ``n_timed`` timed steps (launch counts
    reset just before and read just after: every kernel of ``need``
    launched, none of ``absent``), one profiled step, (``capture``) the
    kNN calls of one more step (exact_calls: the summary's kernel 9
    launches and points per launch), (``scatter``) the weighted scatter's
    calls of one more step (capture_scatter: the summary's
    "scatter_calls"), then ``n_fixed`` steps on one fixed batch."""
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
    calls = capture_knn(lambda: trainer.step(batches[0])) if capture else []
    scatter_calls = capture_scatter(lambda: trainer.step(batches[0])) \
        if scatter else []

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
    if capture:
        summary["knn_calls"] = [[c["N"], c["V"], c["k"]] for c in calls]
        summary.update(exact_calls(calls))
    if scatter:
        summary["scatter_calls"] = scatter_calls
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


# ----------------------------------------------------- the all-far skip

# the far pass's non-FMA f32 operations per (point, 512-vertex tile) pair:
# per axis two subtractions, two maxima and the clamp at 0, then three
# multiplies, two adds and the running minimum (csrc/knn_far.cu far_lb2)
FAR_PAIR_OPS = 18.0
# the SMPL views' dense phases: views of the serving turntable (a subset
# of its angles, whose compacted images the slice phase keeps)
DENSE_ANGLES = (3, 29, 55)


def set_far_skip(system, on: bool) -> None:
    """Turn the kNN's all-far skip on or off by replacing the scene config
    (``AnimNeRFConfig.knn_far_skip``; no system config key sets it)."""
    import dataclasses

    system.scene_cfg = dataclasses.replace(system.scene_cfg,
                                           knn_far_skip=on)
    system.scene.cfg = system.scene_cfg


def far_share() -> dict:
    """The far passes' group counts since the last reset_far_counts."""
    from animnerf_tpu_torch.ops.knn_kernel import far_counts

    groups, skipped = (int(x) for x in far_counts("cuda").tolist())
    return {"far_groups": groups, "far_groups_skipped": skipped,
            "far_skipped_share": skipped / max(groups, 1)}


def reset_counts() -> None:
    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.ops.knn_kernel import reset_far_counts

    _build.reset_launches()
    reset_far_counts()


def dense_views(system, bp, tmpl, angles, H=512, W=512, profile=True):
    """The dense route (``Renderer(compact_samples=False)``) on turntable
    views, with the far skip off, then on: per mode a warm-up view, the
    views with the launch counts reset just before and read just after
    (each view's skipped share of kNN point groups from the far passes'
    counts), then (``profile``) one more view under torch.profiler. The
    images with the skip off and on must be bit-equal."""
    import torch

    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.ops.knn_kernel import reset_far_counts
    from animnerf_tpu_torch.render.inference import (
        Renderer,
        turntable_rotation,
    )

    rays = frame_rays(H, W)
    out = {}
    for on in (False, True):
        set_far_skip(system, on)
        r = Renderer(system, compact_samples=False)

        def view(a):
            return r.render_frame(bp, tmpl, rays, turntable_rotation(a, 64),
                                  (W, H))

        view(angles[0])  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        views, images, total = [], [], {"far_groups": 0,
                                        "far_groups_skipped": 0}
        for a in angles:
            reset_far_counts()
            t0 = time.perf_counter()
            img, mask, depth = view(a)  # host arrays: the device is done
            ms = (time.perf_counter() - t0) * 1e3
            share = far_share()
            for k in total:
                total[k] += share[k]
            finite = bool(np.isfinite(img).all() and np.isfinite(mask).all()
                          and np.isfinite(depth).all())
            check(finite, f"dense view {a}: non-finite output")
            check((mask > 0.5).sum() > 500, f"dense view {a}: no body")
            views.append(dict(view=a, far_skip=on, ms=ms,
                              rays=r.last_counts[0] // system.renderer_cfg
                              .n_coarse, body_px=int((mask > 0.5).sum()),
                              **(share if on else {})))
            images.append((img, mask, depth))
        launches = dict(_build.LAUNCHES)
        prof = profile_call(lambda: view(angles[0]), "view") if profile \
            else None
        out[on] = dict(views=views, images=images, launches=launches,
                       profile=prof,
                       far_skipped_share=total["far_groups_skipped"]
                       / max(total["far_groups"], 1))
    set_far_skip(system, False)
    for a, x, y in zip(angles, out[False]["images"], out[True]["images"]):
        same = all(np.array_equal(u, v) for u, v in zip(x, y))
        diff = max(float(np.abs(u - v).max()) for u, v in zip(x, y))
        check(same, f"dense view {a}: the far skip changed the image "
              f"(max diff {diff})")
    check(out[True]["launches"]["knn_far"] > 0
          and out[False]["launches"]["knn_far"] == 0,
          f"far pass launches off/on: {out[False]['launches']['knn_far']}, "
          f"{out[True]['launches']['knn_far']}")
    return out


def image_diff(a, b) -> dict:
    mse = float(np.mean((a - b) ** 2))
    return {"max_abs": float(np.abs(a - b).max()),
            "psnr_db": 10 * math.log10(1.0 / max(mse, 1e-20))}


def dense_serve(system, bp, tmpl, compact_images):
    """dense_views on the SMPL turntable at 512x512, each image held
    against the compacted renderer's image of the same view (from the
    slice phase) within the bf16 bounds of the parity checks."""
    out = dense_views(system, bp, tmpl, DENSE_ANGLES)
    bound = dict(PARITY_BOUNDS)["bfloat16"]
    agree = []
    for a, (img, _, _) in zip(DENSE_ANGLES, out[True]["images"]):
        d = image_diff(img, compact_images[a])
        agree.append(dict(view=a, **d))
        check(d["max_abs"] <= bound[0] and d["psnr_db"] >= bound[1],
              f"dense vs compacted view {a}: {d}")
    for on in (False, True):
        check(all(out[on]["launches"][k] > 0 for k in SERVE_KERNELS)
              and out[on]["launches"]["knn_exact"]
              == out[on]["launches"]["knn_packed"]
              == out[on]["launches"]["min_dist"] == 0,
              f"dense serving launched the wrong kernels: "
              f"{out[on]['launches']}")
    return out, agree


def dense_eval(system, bp, tmpl, H=512, W=512):
    """``make_eval_step`` on the H x W rays of one frame (no rotation, no
    ray cull), in slabs of ``MAX_RAYS_PER_CALL`` rays, with the far skip
    off, then on: the host-clock time of the frame, its launches and
    skipped share, one profiled frame; the outputs off and on bit-equal,
    and the fine image within the bf16 bounds of the compacted renderer's
    image of the same frame."""
    import torch

    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.render.inference import MAX_RAYS_PER_CALL, Renderer
    from animnerf_tpu_torch.training.system import make_eval_step

    rays = torch.tensor(frame_rays(H, W), device="cuda")
    base = {"frame_idx": torch.tensor([-1], device="cuda"),
            **tensors(bp, "cuda"),
            **{k + "_template": v for k, v in tensors(tmpl, "cuda").items()}}
    step = make_eval_step(system)

    def frame():
        parts = [step(dict(base, rays=rays[None, s:s + MAX_RAYS_PER_CALL]))
                 for s in range(0, rays.shape[0], MAX_RAYS_PER_CALL)]
        return {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}

    out = {}
    for on in (False, True):
        set_far_skip(system, on)
        frame()  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = frame()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.LAUNCHES)
        share = far_share()
        out[on] = dict(ms=ms, launches=launches, **share,
                       profile=profile_call(frame, "frame"),
                       res={k: v.cpu().numpy() for k, v in res.items()})
    set_far_skip(system, False)
    same = all(np.array_equal(out[True]["res"][k], out[False]["res"][k])
               for k in out[False]["res"])
    check(same, "dense eval: the far skip changed the outputs")
    img = out[True]["res"]["rgbs_fine"][0].reshape(H, W, 3)
    check(np.isfinite(img).all(), "dense eval: non-finite output")
    ref, _, _ = Renderer(system).render_frame(bp, tmpl, frame_rays(H, W),
                                              img_wh=(W, H))
    agree = image_diff(img, ref)
    bound = dict(PARITY_BOUNDS)["bfloat16"]
    check(agree["max_abs"] <= bound[0] and agree["psnr_db"] >= bound[1],
          f"dense eval vs compacted frame: {agree}")
    for on in (False, True):
        del out[on]["res"]
    return out, agree


def dense_view_calls(system, bp, tmpl, angle, H=512, W=512) -> list:
    """The kNN calls (with their points) of one dense view with the far
    skip on."""
    from animnerf_tpu_torch.render.inference import (
        Renderer,
        turntable_rotation,
    )

    set_far_skip(system, True)
    r = Renderer(system, compact_samples=False)
    try:
        return capture_knn(lambda: r.render_frame(
            bp, tmpl, frame_rays(H, W), turntable_rotation(angle, 64)),
            keep=True)
    finally:
        set_far_skip(system, False)


def smplx_system():
    """The flagship field at random weights (seed 0, an opaque shell) on
    the seed-0 SMPL-X rig."""
    from animnerf_tpu_torch.system import AnimNeRFSystem

    system = AnimNeRFSystem(SMPLX_CFG, smplx_rig(), device="cuda", seed=0)
    opaque_shell(system)
    return system


def dense_small(system, bp, tmpl, kernels, H=64, W=64, angle=17):
    """One dense H x W view with the far skip off and on (images
    bit-equal; every kernel of ``kernels`` launched with the skip on)."""
    out = dense_views(system, bp, tmpl, (angle,), H, W, profile=False)
    launches = out[True]["launches"]
    check(all(launches[k] > 0 for k in kernels + ("knn_far",)),
          f"dense {H}x{W} launched too few kernels: {launches}")
    return {"view": angle, "shape": [H, W], "bit_equal_off_on": True,
            "ms_off": out[False]["views"][0]["ms"],
            "ms_on": out[True]["views"][0]["ms"],
            "far_skipped_share": out[True]["far_skipped_share"],
            "launches_on": launches}


def far_bound_ms(N: int, V: int, pairs: float, pair_ops: float,
                 nbytes: float) -> float:
    """A kNN call with the far skip: the far pass's FAR_PAIR_OPS per
    (point, 512-vertex tile) pair plus pair_ops per (point, vertex) pair
    the kept groups sweep, over the non-FMA f32 peak, or the bytes read
    and written once over the memory rate, the larger."""
    ops = FAR_PAIR_OPS * N * -(-V // 512) + pair_ops * pairs
    return max(ops / PEAK_F32_NONFMA, nbytes / PEAK_BYTES) * 1e3


def far_pass_line(pts, verts, thr: float, reps: int = 20) -> dict:
    """The far pass alone (``csrc/knn_far.cu``, packed outputs at K=4):
    its flags equal far_groups_plain's decisions and the skipped points'
    outputs far_outputs', bit for bit; its time beside the plain
    version's and its bound (FAR_PAIR_OPS per point and tile, or 12 B a
    point in, the flags and the skipped points' 32 B out)."""
    import torch

    from animnerf_tpu_torch.ops.knn_kernel import (
        FAR_GROUP,
        _far_pass,
        exact_rows,
        far_groups_plain,
        far_outputs,
    )

    N, V = pts.shape[1], verts.shape[1]
    tbox = exact_rows(verts)[2]
    d = torch.zeros((1, 4, N), device="cuda")
    i = torch.full((1, 4, N), -1, dtype=torch.int32, device="cuda")
    flags = _far_pass(pts, verts, thr, d, i, packed=True, tbox=tbox)
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    g, skip = far_groups_plain(pts, verts, thr)
    e.record()
    e.synchronize()
    dp, ip = far_outputs(g, 4, True)
    sk = skip.repeat_interleave(FAR_GROUP, dim=1)[:, :N]
    m = sk[:, None].expand(-1, 4, -1)
    same = bool(torch.equal(flags.bool(), skip) and torch.equal(d[m], dp[m])
                and torch.equal(i[m], ip[m]))
    check(same, "far pass: flags or skipped outputs differ from the plain "
          "version")
    n_skip = int(sk.sum())
    return dict(shape=f"points (1,{N},3) verts (1,{V},3) K=4 packed",
                max_abs_err=float((d[m] - dp[m]).abs().max())
                if n_skip else 0.0, tolerance=0.0, bit_equal=same,
                skipped_share=float(skip.float().mean()),
                ms=time_ms(lambda: _far_pass(pts, verts, thr, d, i, True,
                                             tbox=tbox), reps),
                plain_ms=s.elapsed_time(e),
                bound_ms=far_bound_ms(N, V, 0, 0.0, N * 12 + skip.numel() * 4
                                      + n_skip * 32),
                bound_by="operations", library_ms=None)


def far_kernel_line(name, fn, plain, pts, verts, k: int, thr: float,
                    pair_ops: float, packed: bool, reps: int = 10) -> dict:
    """Kernel fn(pts, verts, far_skip) with the far skip, bit-equal to its
    plain version with it and with the same validity (d < thr) as
    without; its times with and without the skip, the skipped share and
    the bound: the far pass plus pair_ops per pair the kept groups sweep
    (all V vertices a kept point, or kernel 9's swept pairs from its
    stats, passed by fn as stats when it takes them)."""
    import torch

    from animnerf_tpu_torch.ops.knn_kernel import FAR_GROUP, far_groups_plain

    N, V = pts.shape[1], verts.shape[1]
    stats = torch.zeros(2, dtype=torch.int64, device="cuda")
    d, i = fn(pts, verts, thr, stats)
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    dp, ip = plain(pts, verts, thr)
    e.record()
    e.synchronize()
    mism = int((i != ip).sum())
    err = float((d - dp).abs().max())
    check(mism == 0 and torch.equal(d, dp),
          f"{name}: {mism} index mismatches, max err {err} against plain")
    d0, _ = fn(pts, verts, 0.0, None)
    check(torch.equal(d0 < thr, d < thr),
          f"{name}: the far skip changed a point's validity")
    _, skip = far_groups_plain(pts, verts, thr)
    kept = N - int(skip.repeat_interleave(FAR_GROUP, dim=1)[:, :N].sum())
    swept, skipped = (int(x) for x in stats.tolist())
    pairs = swept if swept else kept * V
    nbytes = N * 12 + V * 12 + N * 8 * k
    return dict(shape=f"points (1,{N},3) verts (1,{V},3) K={k}",
                max_abs_err=err, tolerance=0.0, idx_mismatch=mism,
                skipped_share=float(skip.float().mean()), kept_points=kept,
                swept_pairs=pairs,
                ms=time_ms(lambda: fn(pts, verts, thr, None), reps),
                ms_no_far_skip=time_ms(lambda: fn(pts, verts, 0.0, None),
                                       reps),
                plain_ms=s.elapsed_time(e),
                bound_ms=far_bound_ms(N, V, pairs, pair_ops, nbytes),
                bound_no_far_skip_ms=knn_bound_ms(N * V, nbytes)
                if packed else max(EXACT_PAIR_OPS * N * V / PEAK_F32_NONFMA,
                                   nbytes / PEAK_BYTES) * 1e3,
                bound_by="operations", library_ms=None)


def far_kernel_lines(pts, verts, thr: float) -> dict:
    """The far pass and kernels 1, 8 (K=8) and 9 (K=4, with its cull)
    with the far skip on points (1, N, 3) against verts (1, V, 3)."""
    from animnerf_tpu_torch.ops.knn_kernel import (
        knn_exact,
        knn_exact_plain,
        knn_packed,
        knn_packed_plain,
        knn_top4,
        knn_top4_plain,
    )

    lines = {"knn_far": far_pass_line(pts, verts, thr)}
    lines["knn_far2"] = far_kernel_line(
        "knn_far2", lambda p, v, fs, st: knn_top4(p, v, far_skip=fs),
        lambda p, v, fs: knn_top4_plain(p, v, PLAIN_MAX_ELEMS, fs),
        pts, verts, 4, thr, KNN_PAIR_OPS, True)
    lines["knn_packed_far2"] = far_kernel_line(
        "knn_packed_far2", lambda p, v, fs, st: knn_packed(p, v, 8, fs),
        lambda p, v, fs: knn_packed_plain(p, v, 8, PLAIN_MAX_ELEMS, fs),
        pts, verts, 8, thr, KNN_PAIR_OPS, True)
    lines["knn_exact_far2"] = far_kernel_line(
        "knn_exact_far2",
        lambda p, v, fs, st: knn_exact(p, v, 4, stats=st, far_skip=fs),
        lambda p, v, fs: knn_exact_plain(p, v, 4, PLAIN_EXACT_MAX_ELEMS, fs),
        pts, verts, 4, thr, EXACT_PAIR_OPS, False)
    return lines


def far_train_step(dev):
    """One bench.py training step with the far skip off and with it on,
    from the same parameters, batch and noise: loss terms and gradients
    bit-equal (the skip is exact for gradients too: a skipped point's
    sigma is the constant fill); the launch counts of the step with the
    skip on (kernel 1 with the tile skip and the far pass)."""
    import torch

    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.training.system import RowsCompactTrainer
    from animnerf_tpu_torch.utils.rng import draw_noise

    batch = train_batches(16, 1024, [3], dev)[0]
    res = {}
    for on in (False, True):
        system = AnimNeRFSystem(FLAGSHIP_CFG, smpl_rig(), device=dev, seed=0)
        set_far_skip(system, on)
        trainer = RowsCompactTrainer(system, steps_per_epoch=100)
        noise = draw_noise(torch.Generator().manual_seed(7), 16, 1024,
                           system.renderer_cfg,
                           system.body_model.num_verts).to(dev)
        torch.cuda.synchronize()
        reset_counts()
        d = trainer.step(batch, noise)
        torch.cuda.synchronize()
        res[on] = (d, dict(_build.LAUNCHES), far_share(),
                   _grad_groups(system))
    (d0, _, _, g0), (d1, launches, share, g1) = res[False], res[True]
    same_loss = all(bool(torch.equal(d0[k], d1[k])) if torch.is_tensor(d0[k])
                    else d0[k] == d1[k] for k in d0)
    same_grad = all(torch.equal(g0[k], g1[k]) for k in g0)
    check(same_loss and same_grad,
          f"train step: far skip changed loss ({same_loss}) or gradients "
          f"({same_grad})")
    check(launches["knn_far"] > 0 and launches["knn_tile_skip"] > 0,
          f"train step with the far skip: {launches}")
    return {"loss": float(d1["loss"]), "bit_equal_loss": same_loss,
            "bit_equal_grads": same_grad, "launches": launches, **share}


def tile_skip_far_line(dev, thr: float = 0.2) -> dict:
    """Kernel 1 with the tile skip and the far skip on the training
    step's Morton-ordered points (kernel_lines_train's: 16 posed frames,
    32,768 points each, 0.1 m around the cloud), bit-equal to its plain
    version and to the tile skip alone; times with and without the far
    skip and the bound from the warp tiles the kept groups sweep."""
    import torch

    from animnerf_tpu_torch.data.synthetic import (
        make_body_model,
        random_pose_params,
    )
    from animnerf_tpu_torch.models.warp import prepare_frame
    from animnerf_tpu_torch.ops.knn_kernel import (
        knn_top4,
        knn_top4_plain,
        reset_far_counts,
    )
    from animnerf_tpu_torch.ops.perm_sort import _morton_rows

    g = torch.Generator(device=dev).manual_seed(1)
    B, N = 16, 32768
    bm = make_body_model(6890, 24, seed=0).to(dev)
    pose = random_pose_params(24, batch=B, seed=4)
    tmpl = random_pose_params(24, batch=B, seed=2)
    tmpl["transl"] = np.zeros_like(tmpl["transl"])
    with torch.no_grad():
        ctx = prepare_frame(bm, tensors(pose, dev), tensors(tmpl, dev))
    verts = ctx.verts_morton.contiguous()
    V = verts.shape[1]
    pick = torch.randint(0, V, (B, N), generator=g, device=dev)
    pts = torch.gather(verts, 1, pick[..., None].expand(B, N, 3)) \
        + 0.1 * torch.randn(B, N, 3, generator=g, device=dev)
    order = torch.argsort(_morton_rows(pts[..., 0], pts[..., 1],
                                       pts[..., 2]), dim=1, stable=True)
    pts = torch.gather(pts, 1, order[..., None].expand(B, N, 3)).contiguous()
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    reset_far_counts()
    d, i = knn_top4(pts, verts, tile_skip=True, stats=stats, far_skip=thr)
    share = far_share()
    d0, i0 = knn_top4(pts, verts, tile_skip=True)
    dp, ip = knn_top4_plain(pts, verts, PLAIN_MAX_ELEMS, thr)
    torch.cuda.synchronize()
    mism = int((i != ip).sum())
    err = float((d - dp).abs().max())
    check(mism == 0 and torch.equal(d, dp),
          f"knn_tile_skip_far2: {mism} index mismatches, max err {err}")
    check(torch.equal(d0 < thr, d < thr),
          "knn_tile_skip_far2: the far skip changed a point's validity")
    swept, skipped = (int(x) for x in stats.tolist())
    share_swept = swept / max(swept + skipped, 1)
    kept = B * N * (1.0 - share["far_skipped_share"])
    nbytes = B * (N * 12 + V * 12 + N * 32)
    return dict(shape=f"points ({B},{N},3) Morton-ordered verts ({B},{V},3)",
                max_abs_err=err, tolerance=0.0, idx_mismatch=mism,
                skipped_share=share["far_skipped_share"],
                warp_tiles_swept=swept, warp_tiles_skipped=skipped,
                ms=time_ms(lambda: knn_top4(pts, verts, tile_skip=True,
                                            far_skip=thr), 20),
                ms_no_far_skip=time_ms(lambda: knn_top4(
                    pts, verts, tile_skip=True), 20),
                plain_ms=time_ms(lambda: knn_top4_plain(
                    pts, verts, PLAIN_MAX_ELEMS, thr), 1, warmup=1),
                # the far pass over all points, the pairs the tile skip
                # left to sweep in the kept groups
                bound_ms=max((FAR_PAIR_OPS * B * N * -(-V // 512)
                              + KNN_PAIR_OPS * kept * V * share_swept)
                             / PEAK_F32_NONFMA, nbytes / PEAK_BYTES) * 1e3,
                bound_by="operations", library_ms=None)


def kernel_lines_edge_far(dev, thr: float = 0.2) -> dict:
    """Kernels 1 (with and without the tile skip), 8 and 9 with the far
    skip at N = 2^20 - 37 points (the last group partial), K in {1, 4, 8,
    16}: half the points near a seeded cloud (0.3 m) around the origin,
    the other half (the last group's among them) 5 m away; the last
    group's padding points at the origin keep it from skipping. Then the
    cloud moved 3 m from the origin, where the last group skips. Each
    output bit-equal to its plain version with the far skip."""
    import torch

    from animnerf_tpu_torch.ops.knn_kernel import (
        FAR_GROUP,
        far_groups_plain,
        knn_exact,
        knn_exact_plain,
        knn_packed,
        knn_packed_plain,
        knn_top4,
        knn_top4_plain,
    )

    g = torch.Generator(device=dev).manual_seed(8)
    N = EDGE_POINTS
    lines = {}
    for cloud, shift in (("origin", 0.0), ("away", 3.0)):
        for V in (6890, 10475):
            verts = morton_sorted(0.3 * torch.randn(1, V, 3, generator=g,
                                                    device=dev) + shift)
            pick = torch.randint(0, V, (N,), generator=g, device=dev)
            pts = (verts[0, pick] + 0.05 * torch.randn(
                N, 3, generator=g, device=dev))[None].contiguous()
            pts[:, N // 2:] += 5.0
            _, skip = far_groups_plain(pts, verts, thr)
            last = bool(skip[0, -1])
            check(last == (cloud == "away") and bool(skip[0, -2]),
                  f"edge far {cloud}: last group skip {last}")
            runs = []
            if V <= 8192:
                runs += [("knn", 4, lambda K: knn_top4(pts, verts,
                                                       far_skip=thr),
                          lambda K: knn_top4_plain(pts, verts,
                                                   PLAIN_MAX_ELEMS, thr)),
                         ("knn_tile_skip", 4,
                          lambda K: knn_top4(pts, verts, tile_skip=True,
                                             far_skip=thr),
                          lambda K: knn_top4_plain(pts, verts,
                                                   PLAIN_MAX_ELEMS, thr))]
                runs += [("knn_packed", K, lambda K: knn_packed(
                    pts, verts, K, far_skip=thr), lambda K: knn_packed_plain(
                        pts, verts, K, PLAIN_MAX_ELEMS, thr))
                    for K in ((1, 4, 8, 16) if cloud == "origin" else (8,))]
            else:
                runs += [("knn_exact", K, lambda K: knn_exact(
                    pts, verts, K, far_skip=thr), lambda K: knn_exact_plain(
                        pts, verts, K, PLAIN_EXACT_MAX_ELEMS, thr))
                    for K in ((1, 4, 8, 16) if cloud == "origin" else (4,))]
            for kname, K, fn, plain in runs:
                d, i = fn(K)
                dp, ip = plain(K)
                torch.cuda.synchronize()
                mism = int((i != ip).sum())
                err = float((d - dp).abs().max())
                check(mism == 0 and torch.equal(d, dp),
                      f"edge far {kname} K={K} V={V} {cloud}: {mism} index "
                      f"mismatches, max err {err}")
                lines[f"{kname}_far2_{cloud}_k{K}_v{V}"] = dict(
                    shape=f"points (1,{N},3) verts (1,{V},3) K={K}",
                    max_abs_err=err, tolerance=0.0, idx_mismatch=mism,
                    skipped_share=float(skip.float().mean()),
                    last_group_skipped=last,
                    last_group_points=N - (skip.shape[1] - 1) * FAR_GROUP)
    return lines


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
    funcs = library_sass(str(lib.path))
    sass = sweep_sass(funcs)
    exact = exact_sass(funcs)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "cached": lib.cached, "library": os.path.relpath(lib.path, ROOT),
          "ptxas": ptxas,
          "sweep_sass": {f"K={k} {insert}{' tile_skip' if skip else ''}": v
                         for (k, skip, insert), v in sorted(sass.items())},
          "exact_sass": {f"K={k}": v for k, v in sorted(exact.items())}})
    check(all((k, False, "packed") in sass for k in range(1, 17))
          and (4, False, "top4") in sass and (4, True, "top4") in sass,
          f"sweep kernels missing from the SASS: {sorted(sass)}")
    check(sorted(exact) == list(range(1, 17)),
          f"exact kNN kernels missing from the SASS: {sorted(exact)}")

    # the MLP backward's weight-gradient pass first: it also probes the
    # MN-major wgmma descriptors
    t0 = time.perf_counter()
    wline = kernel_line_wgrad("cuda", funcs)
    emit(dict(phase="kernel", name="fused_mlp_wgrad", **wline,
              seconds=time.perf_counter() - t0))

    ck, system, bp, tmpl, ctx = scale512("cuda")
    t0 = time.perf_counter()
    lines = kernel_lines(system, ctx, sass)
    lines["fused_mlp_wgrad"] = wline
    lines.update(kernel_lines_train("cuda", sass))
    for name, line in lines.items():
        if name != "fused_mlp_wgrad":
            emit(dict(phase="kernel", name=name, **line))
    emit({"phase": "kernels_done", "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    for name, line in kernel_lines_edge("cuda").items():
        emit(dict(phase="kernel_edge", name=name, **line))
    for name, line in kernel_lines_edge_scatter_warp("cuda").items():
        emit(dict(phase="kernel_edge", name=name, **line))
    emit({"phase": "edge_done", "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    angles = [3, 17, 29, 41, 55]
    views, serve_launches, prof, images = render_turntable(system, bp, tmpl,
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
    # kernel 2 on the points a view's coarse warp gives it (its first call)
    wcalls = capture_warp_blend(view_fn(system, bp, tmpl, angles[0]))
    lines["warp_blend_view"] = dict(
        warp_blend_call_line(wcalls[0]["args"]),
        view_calls=[[c["N"], c["k"]] for c in wcalls])
    emit(dict(phase="kernel", name="warp_blend_view",
              **lines["warp_blend_view"]))
    del wcalls

    t0 = time.perf_counter()
    parity = slice_parity(ck, bp, tmpl)
    emit({"phase": "slice_parity", **parity,
          "seconds": time.perf_counter() - t0})

    # ---- the dense rows render, with the kNN's all-far skip off and on
    t0 = time.perf_counter()
    dense, dense_agree = dense_serve(system, bp, tmpl, dict(zip(angles,
                                                                images)))
    del images
    for on in (False, True):
        for v in dense[on]["views"]:
            emit(dict(phase="dense_view", **v))
        emit(dict(phase="dense_profile", far_skip=on,
                  **dense[on]["profile"]))
    emit({"phase": "dense_serve", "views": list(DENSE_ANGLES),
          "bit_equal_off_on": True,
          "median_view_ms_off": float(np.median(
              [v["ms"] for v in dense[False]["views"]])),
          "median_view_ms_on": float(np.median(
              [v["ms"] for v in dense[True]["views"]])),
          "far_skipped_share": dense[True]["far_skipped_share"],
          "dense_vs_compacted": dense_agree,
          "bound_vs_compacted": dict(PARITY_BOUNDS)["bfloat16"],
          "launches_off": dense[False]["launches"],
          "launches_on": dense[True]["launches"],
          "seconds": time.perf_counter() - t0})
    dense_launches = dense[True]["launches"]
    del dense

    t0 = time.perf_counter()
    evals, eval_agree = dense_eval(system, bp, tmpl)
    for on in (False, True):
        emit(dict(phase="dense_eval_profile", far_skip=on,
                  **evals[on].pop("profile")))
    emit({"phase": "dense_eval", "rays": 512 * 512, "bit_equal_off_on": True,
          "off": evals[False], "on": evals[True],
          "vs_compacted_frame": eval_agree,
          "seconds": time.perf_counter() - t0})

    # the far-skip kernel lines on the points the dense view's coarse warp
    # passed to the kNN (its first call: the first slab's coarse samples)
    t0 = time.perf_counter()
    calls = dense_view_calls(system, bp, tmpl, DENSE_ANGLES[0])
    thr = system.scene_cfg.dis_threshold
    check(calls and calls[0]["V"] == 6890 and calls[0]["k"] == 4,
          f"the dense view's first kNN call: {calls[:1]}")
    flines = far_kernel_lines(calls[0]["points"], calls[0]["verts"], thr)
    del calls
    flines["knn_tile_skip_far2"] = tile_skip_far_line("cuda", thr)
    for name, line in flines.items():
        emit(dict(phase="kernel", name=name, **line))
    lines.update(flines)
    ftrain = far_train_step("cuda")
    emit({"phase": "far_train_step", **ftrain})
    for name, line in kernel_lines_edge_far("cuda", thr).items():
        emit(dict(phase="kernel_edge", name=name, **line))
    emit({"phase": "far_lines_done", "seconds": time.perf_counter() - t0})
    del system, ctx

    t0 = time.perf_counter()
    steps, summary, prof, losses = train_phase(
        "cuda", absent=("knn_exact", "min_dist", "knn_packed"), scatter=True)
    for st in steps:
        emit(dict(phase="train_step", **st))
    emit(dict(phase="train_profile", **prof))
    lines["scatter_step"] = step_scatter_lines(summary.pop("scatter_calls"))
    emit(dict(phase="kernel", name="scatter_step", **lines["scatter_step"]))
    emit(dict(phase="train", **summary, fixed_batch_losses=losses,
              seconds=time.perf_counter() - t0))
    launches = summary["launches"]

    t0 = time.perf_counter()
    tparity = train_parity("cuda")
    emit({"phase": "train_parity", **tparity,
          "seconds": time.perf_counter() - t0})

    # ---- SMPL-X: the exact kNN and the min-distance pre-pass
    t0 = time.perf_counter()
    xlines = kernel_lines_smplx("cuda", exact)
    for name, line in xlines.items():
        emit(dict(phase="kernel", name=name, **line))
    lines.update(xlines)
    for name, line in kernel_lines_edge_exact("cuda", exact).items():
        emit(dict(phase="kernel_edge", name=name, **line))
    emit({"phase": "edge_exact_done", "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    angles = [3, 29, 55]
    xviews, xserve, profs, bviews, agree, calls, wcalls = smplx_serve(angles)
    for v in xviews:
        emit(dict(phase="smplx_view", **v))
    for prof in profs:
        emit(dict(phase="smplx_profile", **prof))
    emit({"phase": "smplx_serve", "views": len(xviews),
          "median_view_ms": float(np.median([v["ms"] for v in xviews])),
          "median_view_ms_boxes": float(np.median([v["ms"]
                                                   for v in bviews])),
          "survivors_boxes": [[v["n_coarse"], v["n_fine"]] for v in bviews],
          "max_abs_img_exact_vs_boxes": agree, "launches": xserve,
          "launches_per_view": {k: v / len(xviews)
                                for k, v in xserve.items()},
          "profiled_busy_ms": [p["device_busy_ms"] for p in profs],
          "profile_spread_bound": PROFILE_SPREAD,
          "knn_calls": [[c["N"], c["V"], c["k"]] for c in calls],
          **exact_calls(calls), "seconds": time.perf_counter() - t0})

    # kernel 9 on the points the view's coarse warp passed to it (its first
    # kNN call), at K = 4 and 8
    t0 = time.perf_counter()
    check(calls and calls[0]["V"] == 10475,
          f"the SMPL-X view's first kNN call: {calls[:1]}")
    for k, name in ((4, "knn_exact_view"), (8, "knn_exact_view_k8")):
        lines[name] = exact_line(calls[0]["points"], calls[0]["verts"], k,
                                 exact)
        emit(dict(phase="kernel", name=name, **lines[name]))
    lines["warp_blend_smplx"] = dict(
        warp_blend_call_line(wcalls[0]["args"]),
        view_calls=[[c["N"], c["k"]] for c in wcalls])
    emit(dict(phase="kernel", name="warp_blend_smplx",
              **lines["warp_blend_smplx"]))
    emit({"phase": "view_lines_done", "view_calls": view_calls(calls),
          "seconds": time.perf_counter() - t0})
    del calls, wcalls

    t0 = time.perf_counter()
    emit({"phase": "smplx_serve_parity", **smplx_serve_parity(),
          "seconds": time.perf_counter() - t0})

    # one dense 64x64 SMPL-X view, the far skip off and on (kernel 9)
    t0 = time.perf_counter()
    xsystem = smplx_system()
    xdense = dense_small(xsystem, smplx_params(1, 1),
                         smplx_params(1, 2, zero_transl=True),
                         ("knn_exact", "warp_blend", "fused_mlp",
                          "permute_lanes"))
    check(xdense["launches_on"]["knn"] == xdense["launches_on"][
        "knn_packed"] == 0, f"SMPL-X dense view: {xdense['launches_on']}")
    del xsystem
    emit({"phase": "smplx_dense", **xdense,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    steps, xsummary, prof, losses = train_phase(
        "cuda", SMPLX_CFG, smplx_rig, "smplx", n_timed=10, n_fixed=20,
        need=SMPLX_TRAIN_KERNELS, absent=("knn", "min_dist", "knn_packed"),
        capture=True)
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
    wcalls = capture_warp_blend(view_fn(system8, bp, tmpl, 3))
    lines["warp_blend_view_k8"] = dict(
        warp_blend_call_line(wcalls[0]["args"]),
        view_calls=[[c["N"], c["k"]] for c in wcalls])
    emit(dict(phase="kernel", name="warp_blend_view_k8",
              **lines["warp_blend_view_k8"]))
    del wcalls

    # one dense 64x64 view at k_neigh 8, the far skip off and on (kernel 8)
    t0 = time.perf_counter()
    k8dense = dense_small(system8, bp, tmpl, ("knn_packed", "warp_blend",
                                              "fused_mlp", "permute_lanes"))
    check(k8dense["launches_on"]["knn"] == k8dense["launches_on"][
        "knn_exact"] == 0, f"k_neigh 8 dense view: {k8dense['launches_on']}")
    emit({"phase": "k8_dense", **k8dense,
          "seconds": time.perf_counter() - t0})
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
        need=K8_TRAIN_KERNELS, absent=("knn", "knn_exact", "min_dist"),
        scatter=True)
    for st in steps:
        emit(dict(phase="k8_train_step", **st))
    emit(dict(phase="k8_train_profile", **prof))
    lines["scatter_step_k8"] = step_scatter_lines(
        k8summary.pop("scatter_calls"))
    emit(dict(phase="kernel", name="scatter_step_k8",
              **lines["scatter_step_k8"]))
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
    check(x8launches["knn_exact"] == x8launches["knn_exact_cull"] > 0
          and x8launches["knn"] == x8launches["knn_packed"] == 0,
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
    # k_neigh 8 parity view's (card side) for kernel 9 at K = 8; the SMPL-X
    # serve phase's for kernel 9 on the view's points; the kNN tool's for
    # kernel 9 without its cull, kernel 8 at K = 4 and kernel 10 (one count
    # for both precisions)
    k8 = {k: k8serve[k] + k8summary["launches"][k]
          for k in ("knn_packed", "warp_blend", "scatter")}
    row_launches = dict(
        launches,
        knn_exact=xserve["knn_exact"] + xsummary["launches"]["knn_exact"],
        min_dist=xserve["min_dist"] + xsummary["launches"]["min_dist"],
        knn_packed=k8["knn_packed"], warp_blend_k8=k8["warp_blend"],
        scatter_k8=k8["scatter"], knn_exact_k8=x8launches["knn_exact"],
        scatter_step=launches["scatter"],
        scatter_step_k8=k8summary["launches"]["scatter"],
        warp_blend_view=serve_launches["warp_blend"],
        warp_blend_smplx=xserve["warp_blend"],
        warp_blend_view_k8=k8serve["warp_blend"],
        knn_exact_view=xserve["knn_exact_cull"],
        knn_exact_view_k8=x8launches["knn_exact_cull"],
        knn_exact_nocull=blaunches["knn_exact"] - blaunches["knn_exact_cull"],
        knn_packed_k4=blaunches["knn_packed"], knn_mxu=blaunches["knn_mxu"],
        knn_mxu_default=blaunches["knn_mxu"],
        # the far skip: the dense SMPL views with it on (the far pass and
        # kernel 1), the dense k_neigh 8 and SMPL-X views (kernels 8 and
        # 9), the training step with it on (kernel 1 with the tile skip)
        knn_far=dense_launches["knn_far"], knn_far2=dense_launches["knn"],
        knn_packed_far2=k8dense["launches_on"]["knn_packed"],
        knn_exact_far2=xdense["launches_on"]["knn_exact"],
        knn_tile_skip_far2=ftrain["launches"]["knn_tile_skip"])
    lines["knn_exact_nocull"] = dict(lines["knn_exact"],
                                     ms=lines["knn_exact"]["ms_nocull"],
                                     bound_ms=lines["knn_exact"]["bound_all_ms"])
    rows = []
    for name, (src, replaces) in KERNELS.items():
        ln = lines[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": row_launches[name],
                     "max_abs_err": ln["max_abs_err"], "ms": ln["ms"],
                     "plain_ms": ln["plain_ms"], "bound_ms": ln["bound_ms"],
                     "bound_by": ln["bound_by"],
                     "library_ms": ln["library_ms"],
                     **({"functions": {k: v[0] for k, v in
                                       ln["kernels"]["by_kernel"].items()}}
                        if "kernels" in ln else {})})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
