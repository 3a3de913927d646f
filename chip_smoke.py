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
     in one profiled call, and the backward again at n_freqs 4 and 16
     (its 64- and 128-column encoding blocks) in bf16 and f32 beside the
     library VJP in the same dtype; the kNN lines of kernels 1 and 8 with their
     share of the bound, their sweep's points per thread and its SASS
     instructions per pair; then kernels 1 and 8 at edge shapes (N = 2^20 - 37,
     V in {K, 1025, 8192}, K in {1, 4, 8, 16}, and kernel 8's
     warp-per-point kernel at K in {24, 33, 40, 64} on those V and a 1/64
     tie grid), each bit-equal to its plain version; the scatter at K in
     {1, 4, 8, 16} with one, two and three radix passes (bit-equal to its
     plain version and to a second run) and the warp-blend on every
     family's row width and an unaligned table at K in {1, 4, 8, 16, 24,
     33, 40, 64}, from 24 also with ``warp_view`` and on a table of V = K
     rows (within 1e-4, residual-free out bit-equal, the group kernel
     bit-equal to the thread route);
  4. serving: the trained scale512 checkpoint on the seed-3 SMPL rig, a
     512x512 turntable rendered through ``Renderer.render_stream``,
     launch counts reset just before and read just after; then one more
     view under torch.profiler (device time by kernel, the MLP forward's
     and the kNN's shares, the scatter's and the warp-blend's time and
     launches, idle share); then ``warp_blend_view``: kernel 2 on the
     arguments of a view's first call (its coarse warp), within 1e-4 of
     its plain version, with the residual-free mode's time and out;
  5. serving parity: one view at 96x96 rendered on the card with the
     kernels and on the CPU with the plain versions; then
     ``knn_packed_off``: scale512's view 29 at 512x512 with the packed kNN
     and with ``ANIMNERF_KNN_PACKED=0`` (launch counts of each: kernel 9
     in place of kernels 1 and 8), kernel 9 on a 65,536-point sample of
     that view's first kNN call bit-equal to its plain version, the
     images within PACKED_OFF_BOUNDS;
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
     losses and gradients throughout; ``compact_train``: the opt-in
     point-major compacted step (``make_trainer(engine="compact")``) at
     the same width, its loss and gradients on one batch and noise
     against the dense and the rows engines within COMPACT_BOUND (and
     whether the loss is bit-equal to the dense one), 10 timed steps
     (kernels 1-6 launched), the survivor share, a profiled step by
     kernel, and the rows engine's 10 steps and profile beside it;
  7. train parity: one step at full width with 2 x 128 rays on the card
     (kernels) and on the CPU (plain versions) from the same parameters
     and noise, in f32 and in bf16: loss terms, gradients per parameter
     group and the parameters after one SGD-momentum step; then the same
     at freqs_xyz 4 and 16 (``freqs_train_parity``, the MLP backward's
     other encodings, with their launch counts); ``split_train_parity``
     holds the ``codes`` step at 4 frequencies and at 10, there its DeRF,
     code and body gradients within CODES10_MULT times the JAX package's
     own measured spread (tests/test_torch_codes_spread.py);
  7+. dist: data parallelism (``animnerf_tpu_torch/parallel/``) in ranks
     spawned with a file:// rendezvous, each group under a join time
     limit: (a) one rank over NCCL, bench.py's step through
     ``make_sharded_trainer`` bit-equal (losses, every parameter) to
     ``RowsCompactTrainer.step`` over three steps, both steps' ms, the
     gradient all-reduce's own ms and bytes; (b) two gloo ranks sharing
     the card, 8 x 1024 rays each: kernels 1-6 launched on each rank,
     step 1's loss terms and gradients against the one-process 16 x 1024
     step (DIST_BOUNDS), the replicas bit-equal after three steps, the
     step ms per rank (DIST_LABEL); (c) on those ranks the scale512
     512x512 evaluation frame through ``make_sharded_eval_step`` and a
     view through ``Renderer(mesh=)``, each bit-equal to one process (or
     within the bf16 image bounds, with the difference printed);
  7-. prepare_template: the template tool at 64^3 points against the
     seed-3 V=6890 rig on the card (wall time, the distance pass's
     profile), card against CPU on 4,096 points (PREP_REL, signs outside
     PREP_SIGN_BAND of the surface), the closed sphere's four signs;
  7-. prep_tools: ``tools/rvm.py`` on eight 512x512 PNG frames with a
     small recurrent TorchScript matting model loaded onto the card, its
     RGBA PNGs equal to a CPU run of the same file, the warm-up frames
     not written; ``tools/vibe_driver.py`` on 30 frames of two
     fabricated people with an injected detector and a small torch
     regressor on the card, then ``tools/convert_vibe.py`` on its output:
     the tracklets, the pickles' keys and shapes, ``orig_cam`` against
     numpy's formula; each step's ms;
  7-. trace_syncs: the tracer (``utils/trace.py``) on one bench.py step
     and one 512x512 scale512 view under ``torch.cuda``'s sync debug
     mode: every synchronising call inside a wait span (those of the
     backward, reported when it returns, as many as its wait spans); the
     wait spans by name; each path's spans against their ranges in a
     CPU + CUDA profiler trace (within TRACE_CLOCK_US in one of up to
     three sessions); each path's
     host ms a call off, recording and under a CUDA-only profiler with
     the spans on and off, in turns, with its spans' host and self ms;
     the host ns of a span off, recording and under that profiler;
  7a. fit: training from a dataset on disk as the train CLI runs it: the
     port writes a synthetic dataset (12 frames at 512x512 on the V=6890
     seed-0 rig), ``fit`` takes 60 steps of 16 x 32^2 foreground_pixel
     rays (the flagship field in bf16) with the launch counts reset just
     before and read just after (kernels 1-6 launched), renders one
     validation frame and writes the checkpoints; ``evaluate`` scores the
     2 test frames from ``last``; ``last`` loaded into a fresh system
     gives the trained parameters bit for bit. Host-clock medians of the
     step, the wait on the loader and the producer's batch beside phase
     6's step median; the validation and evaluation ms per frame, the
     checkpoint save ms, the first and last five losses, the test PSNR
     and SSIM;
   7a+. dist_torchrun: ``torchrun --standalone --nproc_per_node 1 -m
     animnerf_tpu_torch.cli.train`` (NCCL) on the fit dataset for
     DIST_FIT_STEPS steps, its ``last`` bit-equal to a one-process
     ``fit`` of the same steps;
   7b. cli: the post-training CLIs through their ``main`` on the card, on
     the fit phase's dataset and ``last``, the launch counts reset just
     before and read just after each: ``novel_view`` (8 views at 512x512,
     again with ``--betas_2th 0.5``, one ``--template`` view; ms a view,
     the GIF's ms a frame, kernels 1-4), ``novel_pose`` (a seeded 8-frame
     mocap; render, body model and raster ms a frame), ``extract_mesh``
     at its default 256^3 grid with ``--vis`` (the query, with its points
     a second, smoothing, marching, the OBJ and the raster timed apart;
     vertex and face counts; kernels 1-3); then the mesh CLI's query
     again with ``knn_far_skip`` off and on: the sigma grids bit-equal,
     both times and the skipped share of kNN groups;
  7c. mesh_scale512: ``extract_mesh`` at 256^3 on the trained scale512
     system in its optimised frame-1 pose, cut at sigma 3 (as
     ``tools/mesh_demo.py`` cut it), its stages timed, its vertex and
     face counts beside ``docs/demo/scale512/mesh_stats.json``'s
     (printed, not checked);
  7d. cli_parity: ``query_sigma_observed`` on a 48^3 grid about that body
     on the card and on the CPU, in f32 and bf16, within 1e-3 and 5e-2 of
     1 + max |sigma|; the native marching of the card's field against
     ``marching_tets_numpy`` through ``marching_model`` (soups bit-equal
     after sorting the triangles, the merge bit-equal to the native);
  7e. lpips (on the fit dataset): seeded torchvision-layout AlexNet and
     lpips-head files converted by ``models/lpips.py`` (the .npz equal to
     the arrays saved); the scale512 run's 512x512 validation render
     against its ground truth (docs/demo/scale512/fit_val.png) scored on
     the card and on the CPU within LPIPS_REL, also with cuDNN's global
     TF32 switch on (the score unchanged) and, for the record, with TF32
     let into LPIPS's convolutions; the pair timed by CUDA events beside
     its FP32 bound; ``evaluate`` with ``$ANIMNERF_LPIPS_WEIGHTS`` set:
     lpips beside PSNR and SSIM (equal to the fit phase's), the ms of an
     eval frame's render and scores with and without LPIPS;
  7f. convert_parity (on the fit dataset): a Lightning .ckpt of the
     scale512 field and the fit run's body params under the reference's
     names, with decoys, its hyper-parameters a yacs ``CfgNode`` stand-in
     (a dict subclass whose module exists only while the file is
     written), converted by ``tools/convert_checkpoint.py`` (every array
     bit-equal to its tensor, the config's sections in meta.json), then
     ``tools/parity_check.py --ref_lpips`` on the card: PSNR, SSIM and
     LPIPS equal to ``evaluate`` on the original checkpoint;
 8. SMPL-X kernel lines: the exact kNN (kernel 9, with and without its
     cull, at K = 4 and 8, random-order points: the swept share, both
     bounds, SASS per pair) and the nearest-vertex distance against the
     seed-0 SMPL-X rig (V=10475, J=55), each bit-equal to its plain
     version on the card; then kernel 9 at edge shapes (N = 2^20 - 37,
     V in {K, 513, 8193, 10475}, K in {1, 4, 8, 16}, and a tie-rich 1/64
     grid cloud; its warp-per-point kernel at K in {24, 33, 40, 64} on
     2^16 - 37 points, the tie cloud among them), with and without its
     cull, each bit-equal to its plain version, and its rows kernel to its
     plain version;
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
 13a. above 16 neighbours: kernel lines of kernels 8 and 9 at K in
     WIDE_KNN_KS (17-160: the kernel that ran, its swept share and both
     bounds; ``knn_routes``: both routes' times at the thresholds on two
     shapes), of kernel 2 at {17, 24, 32, 40, 64, 128} (its group
     kernel bit-equal to the thread route, warp_blend_fwd_any, and within
     1e-4 of its plain version, both routes' times; 2^16 points from 64
     on) and
     of kernel 5 at {17, 24, 32, 40} (within its K = 8 tolerance), then
     the main paths at k_neigh 24 and 40 with their launch counts (every
     warp-blend launch on the group kernel): a training step card
     against CPU on the rigid SMPL rig, a 64x64 view (24) and a 32x32
     SMPL-X view (kernel 9); then k40_profile (the bench.py step, a 512^2
     SMPL view and a 512^2 SMPL-X view at k_neigh 40, each timed and
     profiled), k40_view_calls (kernel 2 on those two views' captured
     calls: its time, bound and the plain version's time in 2^19-point
     chunks) and warp_routes (kernel 2's routes at K = 8, 12, 16, 17 on
     a random-order cloud and a view's call, bit-equal); the far
     pass's line carries its device time from the profiler beside the
     CUDA-event time;
 14. the matmul-form kNN (kernel 10, on the tensor cores) at "highest"
     and "default" against its plain version at the kNN tool's shapes and
     on a 1/64 tie grid (``mxu_check``: sorted d2 within eps, an index
     differing only at near-ties; the operands packed on the card
     bit-equal to ``mxu_operands``), then the port's kNN tool
     (``animnerf_tpu_torch/tools/bench_knn.py``): every row, with the
     launch counts reset just before and read just after;
 15. the kernels summary line (with each kernel's launches in the fit
     phase, ``fit_launches``, in the cli phase, ``cli_launches``, in the
     compact step, ``compact_launches``, and kernel 9's in the packed-off
     view, ``packed_off_launches``), the card line, then the final status
     line.
The kNN, min-distance and MLP-forward lines also time the nearest PyTorch
composite (``library_ms``: cdist then topk or amin by chunks of points;
the encoding and bf16 F.linear chain).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
# kernels 1, 8 (the sweep and its rows kernel; knn_packed_wide and
# knn_packed_any above the threshold) and 9 (its sweep and rows kernel,
# knn_exact_kernel, knn_exact_wide, knn_exact_any and knn_exact_rows), and
# the far pass of their all-far skip, by profiler name
KNN_KERNEL_NAMES = ("knn_sweep::", "knn_rows_kernel", "knn_exact",
                    "knn_far_kernel", "knn_packed")
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
# kernel 3 in f32 by points and kernel 6 in f32 at 2^16 points by
# n_freqs, on the first SIMT kernels before their redesign onto one
# register-tiled f32 routine (tools/ab_mlp_f32.py, the mean of the
# parent checkout's two runs, H100 80GB HBM3, 700 W): the kernel lines'
# earlier times
PREV_F32_FWD_MS = {1 << 21: 119.535, 1 << 16: 3.979}
PREV_F32_BWD_MS = {10: 15.543, 4: 15.421, 16: 15.963}
# the weighted scatter (kernel 5: torch.sort, then a row kernel) and the
# warp-blend (kernel 2: scalar loads) before their redesign, by K (H100
# 80GB HBM3, 700 W): the kernel lines' earlier times
PREV_SCATTER_MS = {4: 0.549, 8: 0.762}
PREV_WARP_BLEND_MS = {4: 0.573, 8: 1.003}
# kernel 2's library column: there is no one-call PyTorch counterpart
WARP_BLEND_LIBRARY = ("none: no single PyTorch call gathers, gates, blends "
                      "and warps")


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


# points a chunk of the library kNN composites: a (chunk x V) f32 distance
# matrix of ~0.9 GB at V = 6890
LIBRARY_CHUNK = 1 << 15


def library_knn_ms(pts, verts, k: int, reps: int = 3) -> float:
    """The nearest PyTorch composite of kernels 1, 8, 9 and 10:
    ``torch.cdist`` then ``torch.topk`` (k smallest) over chunks of
    LIBRARY_CHUNK points of each batch row; CUDA-event ms of one pass."""
    import torch

    def run():
        for b in range(pts.shape[0]):
            for s in range(0, pts.shape[1], LIBRARY_CHUNK):
                torch.cdist(pts[b, s:s + LIBRARY_CHUNK], verts[b]).topk(
                    k, dim=-1, largest=False)

    return time_ms(run, reps, warmup=1)


def library_min_dist_ms(pts, verts, reps: int = 3) -> float:
    """Kernel 7's composite: ``torch.cdist(...).amin(-1)`` by chunks."""
    import torch

    def run():
        for s in range(0, pts.shape[1], LIBRARY_CHUNK):
            torch.cdist(pts[0, s:s + LIBRARY_CHUNK], verts[0]).amin(-1)

    return time_ms(run, reps, warmup=1)


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
                library_ms=library_knn_ms(pts, verts, k),
                library_call="torch.cdist + torch.topk, 32768-point chunks",
                **exact.get(k, {}))


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
        c = {"N": int(args[2].shape[2]), "k": int(args[2].shape[1]),
             "warp_view": bool(kw.get("warp_view", False))}
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


def warp_blend_call_line(args: tuple, reps: int = 20,
                         warp_view: bool = False) -> dict:
    """A kernel line of the warp-blend on a captured call's arguments
    (``warp_view``: with the view-direction rows warped too): within 1e-4
    of its plain version (every output), its time (CUDA events) and bound
    (inputs read once, outputs written once), the bytes of the gathered
    table rows (N * K * F * 4) as a field of their own, and, where the
    wrapper has it, the residual-free mode (``out`` only): its time, its
    own bound, and its ``out`` bit-equal to the full mode's."""
    import inspect

    import torch

    from animnerf_tpu_torch.ops.warp_blend import (
        warp_blend_fwd,
        warp_blend_fwd_plain,
    )

    kw = {"warp_view": True} if warp_view else {}
    rows, d, idx, table, num_lbs = args[:5]
    B, K, N = idx.shape
    F = table.shape[2]
    out = warp_blend_fwd(*args, **kw)
    outp = warp_blend_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, outp))
    tol = 1e-4  # f32 blend; nvcc contracts the blend sums into FMAs
    check(err <= tol, f"warp_blend ({B},{K},{N}) F={F}: max err {err}")
    del outp
    # per point: 3 xyz floats (6 with the view direction), K distances
    # and K indices; the table once
    in_bytes = ((6 if warp_view else 3) * N + 2 * K * N) * B * 4 \
        + table.numel() * 4
    ops = B * N * (K * (3 * num_lbs + 40) + 100 + (21 if warp_view else 0))
    line = dict(
        shape=f"rows ({B},8,{N}) knn ({B},{K},{N}) table "
        f"{tuple(table.shape)}", max_abs_err=err, tolerance=tol,
        gathered_bytes=B * N * K * F * 4,
        ms=time_ms(lambda: warp_blend_fwd(*args, **kw), reps),
        plain_ms=time_ms(lambda: warp_blend_fwd_plain(*args, **kw), 3),
        kernels=kernel_split(lambda: warp_blend_fwd(*args, **kw),
                             WARP_BLEND_KERNEL_NAMES),
        bound_ms=max((in_bytes + B * N * (8 + K + 16) * 4) / PEAK_BYTES,
                     ops / PEAK_F32) * 1e3, bound_by="bytes",
        library_ms=None,
        library_call=WARP_BLEND_LIBRARY)
    line["pct_of_bound"] = 100.0 * line["bound_ms"] / line["ms"]
    if "residuals" in inspect.signature(warp_blend_fwd).parameters:
        o = warp_blend_fwd(*args, residuals=False, **kw)[0]
        same = bool(torch.equal(o, out[0]))
        check(same, f"warp_blend ({B},{K},{N}) F={F}: the residual-free "
              "out differs from the full mode's")
        line.update(
            out_only_bit_equal=same,
            out_only_ms=time_ms(
                lambda: warp_blend_fwd(*args, residuals=False, **kw), reps),
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
        bound_by="operations", library_ms=library_knn_ms(pts, verts, 4),
        library_call="torch.cdist + torch.topk, 32768-point chunks")

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
        bound_by="bytes", library_ms=None, library_call=WARP_BLEND_LIBRARY)

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
        bound_by="operations", library_ms=library_knn_ms(pts, verts, 8),
        library_call="torch.cdist + torch.topk, 32768-point chunks")
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
        library_ms=library_knn_ms(pts, verts, 4),
        library_call="torch.cdist + torch.topk, 32768-point chunks")
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
        bound_by="bytes", library_ms=None, library_call=WARP_BLEND_LIBRARY)
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
    # kernel 3 in f32: its own line (no rounding, f32 accumulation)
    lines["fused_mlp_f32"] = mlp_f32_line(nerf, xrows, reps, preps)
    err32 = lines["fused_mlp_f32"]["max_rel_err"]
    bound = max(M * fwd_flops(10) / PEAK_BF16,
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
        bound_by="operations",
        library_ms=time_ms(lambda: library_mlp_fwd(
            nerf.state_dict(), xrows), 5, warmup=1),
        library_call="library_mlp_fwd: the encoding and F.linear in bf16 "
                     "(cuBLAS)")

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


def f32_smem_check() -> dict:
    """The f32 kernels' shared memory as the C entry animnerf_mlp_f32_smem
    reports it against its host restatement ops/fused_mlp.py::f32_smem
    (which the CPU tests hold under 232,448 B), at every n_freqs each
    kernel takes: {block: [forward bytes, backward bytes]}."""
    import ctypes

    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.ops.fused_mlp import (
        MAX_BWD_FREQS,
        MAX_FREQS,
        f32_smem,
    )

    out = {}
    for n in range(MAX_FREQS + 1):
        for backward in (False, True):
            if backward and n > MAX_BWD_FREQS:
                continue
            ec, stages, nbytes = f32_smem(n, backward)
            got = (ctypes.c_longlong * 2)()
            _build.kernel_library().call("animnerf_mlp_f32_smem", ec,
                                         int(backward), ctypes.addressof(got))
            check((got[0], got[1]) == (nbytes, stages),
                  f"f32 shared memory at n_freqs {n} (backward {backward}): "
                  f"C {tuple(got)}, host {(nbytes, stages)}")
            out.setdefault(f"EC {ec}", [None, None])[int(backward)] = nbytes
    return out


def group_max_k_check() -> dict:
    """The warp-blend group kernel's largest k as the C entry
    animnerf_warp_blend_group_max_k reports it, against its host
    restatement ops/warp_blend.py::group_max_k, at each family's LBS
    width."""
    import ctypes

    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.ops.warp_blend import group_max_k

    out = {}
    for num_lbs in (5, 16, 24, 52, 55):
        got = ctypes.c_int()
        _build.kernel_library().call("animnerf_warp_blend_group_max_k",
                                     num_lbs, ctypes.addressof(got))
        want = group_max_k(num_lbs)
        check(got.value == want, f"group kernel max k at num_lbs "
              f"{num_lbs}: C {got.value}, host {want}")
        out[f"num_lbs {num_lbs}"] = got.value
    return out


def fwd_flops(n_freqs: int) -> float:
    """The MLP forward's operations a point (2 a multiply-add): xyz_0 and
    the skip's enc half over the 3 + 6 n_freqs encoding columns, the
    seven 256-wide trunk products, the sigma head, xyz_final, dir_0 and
    the rgb head; 1,179,904 at the flagship's 10 frequencies."""
    enc = 3 + 6 * n_freqs
    return 2.0 * (enc * 256 * 2 + 7 * 256 * 256 + 256 * 1 + 256 * 256
                  + 256 * 128 + 128 * 3)


# kernel 3's f32 line: the main path's rows and a 2^16-point slice
MLP_F32_POINTS = (1 << 21, 1 << 16)


def mlp_f32_line(nerf, xrows, reps: int, preps: int) -> dict:
    """Kernel 3 in f32 (no rounding, f32 accumulation) on the scale512
    weights and the serving line's points: within 1e-4 of its plain
    version (|d| / (1 + |plain|)) and bit-equal across two launches, at
    the main path's rows (1, 8, 2^21); timed there and on the first 2^16
    points, beside the plain version, the operation bound (fwd_flops over
    PEAK_F32) and ``library_mlp_fwd`` in full f32. TF32 is off
    (``torch.backends.cuda.matmul.allow_tf32`` False, as
    utils/device.py::pin_fp32_geometry sets it), so the library chain
    computes the same function."""
    import torch

    from animnerf_tpu_torch.ops.fused_mlp import (
        fused_nerf_fwd,
        fused_nerf_fwd_plain,
        kernel_image,
        pack_params,
    )

    check(not torch.backends.cuda.matmul.allow_tf32,
          "fused_mlp f32: TF32 matmuls are on")
    state = {k: v.detach() for k, v in nerf.state_dict().items()}
    ws, bs = pack_params(state, 10, "float32")
    image = kernel_image(ws)
    o = fused_nerf_fwd(xrows, ws, bs, 10, "float32", image)
    o2 = fused_nerf_fwd(xrows, ws, bs, 10, "float32", image)
    op = fused_nerf_fwd_plain(xrows, ws, bs, 10, "float32")
    torch.cuda.synchronize()
    deterministic = bool(torch.equal(o, o2))
    err = float(((o - op).abs() / (1.0 + op.abs())).max())
    abs_err = float((o - op).abs().max())
    check(deterministic, "fused_mlp f32: two launches differ")
    check(err <= 1e-4, f"fused_mlp f32: rel err {err}")
    check(bool((o[0, 4:] == 0).all()), "fused_mlp f32: rows 4..7 not zero")
    del o, o2, op
    by_points = {}
    for M in MLP_F32_POINTS:
        x = xrows[..., :M].contiguous()
        ms = time_ms(lambda: fused_nerf_fwd(x, ws, bs, 10, "float32", image),
                     reps if M < MLP_F32_POINTS[0] else 5)
        bound = M * fwd_flops(10) / PEAK_F32 * 1e3
        by_points[M] = dict(
            ms=ms, prev_ms=PREV_F32_FWD_MS.get(M),
            plain_ms=time_ms(lambda: fused_nerf_fwd_plain(
                x, ws, bs, 10, "float32"), preps, warmup=1),
            bound_ms=bound, pct_of_bound=100.0 * bound / ms,
            library_ms=time_ms(lambda: library_mlp_fwd(
                state, x, 10, "float32"), 5, warmup=1))
    main = by_points[MLP_F32_POINTS[0]]
    return dict(
        shape=f"rows (1,8,{xrows.shape[-1]}) f32 weights 13 packed, "
              "scale512", max_abs_err=abs_err, max_rel_err=err,
        tolerance="1e-4 of 1 + |plain|",
        deterministic=deterministic, **main, bound_by="operations",
        points_2p16=by_points[MLP_F32_POINTS[1]], tf32=False,
        library_call="library_mlp_fwd: the encoding and F.linear in f32 "
                     "(cuBLAS, TF32 off)")


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
    from animnerf_tpu_torch.models.warp import prepare_frame
    from animnerf_tpu_torch.ops.blend import (
        weighted_scatter_rows,
        weighted_scatter_rows_plain,
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
        bound_by="operations", library_ms=library_knn_ms(pts, verts, 4),
        library_call="torch.cdist + torch.topk, 32768-point chunks")
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
    for dt in ("bfloat16", "float32"):
        name = "fused_mlp_bwd" if dt == "bfloat16" else "fused_mlp_bwd_f32"
        lines[name] = mlp_bwd_line(dev, g, 10, dt, reps, preps,
                                   profile=True)
    return lines


# the MLP backward's lines: bf16 over 2^20 points, f32 over 2^16
MLP_BWD_POINTS = {"bfloat16": 1 << 20, "float32": 1 << 16}
# Tolerances. A ReLU pre-activation within a rounding of 0 can take the
# other side of the mask in the two versions (f32: one point in ~10^4
# here); its d_xyz then differs outright and its term moves the
# weight-gradient sums, which cancel to ~1/sqrt(M) of their terms. So:
# per-point d_xyz relative error, median and the share above 1e-3, and
# rel-L2 of every gradient. bf16: besides, tensor-core and cuBLAS sum
# orders flip bf16 roundings of the cotangents.
MLP_BWD_TOLS = {"bfloat16": dict(median_point=2e-2, flip_share=0.5,
                                 rel_l2=2e-2),
                "float32": dict(median_point=1e-5, flip_share=1e-3,
                                rel_l2=1e-2)}


def mlp_bwd_line(dev, g, n_freqs: int, dt: str, reps: int, preps: int,
                 profile: bool = False) -> dict:
    """Kernel 6 (the fused MLP backward) at n_freqs in dtype dt against its
    plain version, on MLP_BWD_POINTS[dt] seeded points, under MLP_BWD_TOLS
    (the 10-frequency line's): also bit-equal across two runs, its bound
    and library_mlp_vjp in the same dtype; ``profile``: the main kernel and
    the weight-gradient pass timed apart in one profiled call."""
    import torch

    from animnerf_tpu_torch.models.nerf import NeRFMLP
    from animnerf_tpu_torch.ops.fused_mlp import (
        bwd_layout,
        fused_nerf_bwd,
        fused_nerf_bwd_plain,
        kernel_image,
        pack_params,
    )

    torch.manual_seed(0)
    mlp = NeRFMLP(n_freqs, "float32").to(dev)
    state = {k: v.detach() for k, v in mlp.state_dict().items()}
    flops = fwd_flops(n_freqs)
    M, tol = MLP_BWD_POINTS[dt], MLP_BWD_TOLS[dt]
    peak = PEAK_BF16 if dt == "bfloat16" else PEAK_F32
    ws, bs = pack_params(state, n_freqs, dt)
    xyz = torch.zeros(1, 8, M, device=dev)
    xyz[0, :3] = 0.3 * torch.randn(3, M, generator=g, device=dev)
    dout = torch.zeros(1, 8, M, device=dev)
    dout[0, :4] = 1e-3 * torch.randn(4, M, generator=g, device=dev)
    a = fused_nerf_bwd(xyz, ws, bs, dout, n_freqs, dt)
    a2 = fused_nerf_bwd(xyz, ws, bs, dout, n_freqs, dt)
    b = fused_nerf_bwd_plain(xyz, ws, bs, dout, n_freqs, dt)
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
    what = f"fused_mlp_bwd {dt} n_freqs {n_freqs}"
    check(deterministic, f"{what}: two runs differ")
    check(median_point <= tol["median_point"]
          and flip_share <= tol["flip_share"]
          and max(rel) <= tol["rel_l2"],
          f"{what}: median point {median_point}, flip share {flip_share}, "
          f"rel-L2 {max(rel)}")
    layout = bwd_layout(n_freqs)
    # the H and G scratch a point (the encoding block, 9 + 9 arrays of
    # 256 and 2 of 128), written by the main kernel and read by the
    # weight-gradient pass, in the compute dtype: 9,856 B in bf16 at 64
    # encoding columns
    scratch_bytes = ((layout.cols + 18 * 256 + 2 * 128)
                     * (2 if dt == "bfloat16" else 4))
    image = kernel_image(ws)
    split = {}
    if profile:
        # device time of the main kernel (recompute + dgrad) and of the
        # rest (weight gradients, head and bias sums, split reduction) in
        # one profiled call, and of each kernel by name; the main kernel's
        # own bound: its products (2x the forward's flops) or the H and G
        # scratch it writes, the larger (the weight image prebuilt, as the
        # training step passes it: the call then launches only the
        # backward's own kernels, which must account for its whole
        # device-busy time)
        split = split_bwd_profile(
            lambda: fused_nerf_bwd(xyz, ws, bs, dout, n_freqs, dt, image))
        split["accounted_share"] = ((split["main_ms"] + split["wgrad_ms"])
                                    / split["busy_ms"])
        check(abs(split["accounted_share"] - 1.0) <= 0.02,
              f"{what}: main + rest {split['main_ms']} + "
              f"{split['wgrad_ms']} ms of {split['busy_ms']} ms busy")
        # the rest's own bound: the products dW_l = G_l^T H_l (the
        # forward's flops) or one read of the scratch and the head
        # cotangents (+ 16 B a point), the larger
        split.update(
            bound_main_ms=max(2.0 * flops * M / peak,
                              M * scratch_bytes / PEAK_BYTES) * 1e3,
            bound_wgrad_ms=max(flops * M / peak,
                               M * (scratch_bytes + 16) / PEAK_BYTES) * 1e3,
            **({"prev_ms": PREV_BWD_MS} if n_freqs == 10
               and dt == "bfloat16" else {}))
    line = dict(
        shape=f"rows (1,8,{M}) dout (1,8,{M}) {dt} weights 13 packed, "
              f"n_freqs {n_freqs} (encoding rows {layout.rows}, block "
              f"{layout.cols})",
        max_abs_err=err, max_rel_l2=max(rel),
        median_point_rel=median_point, point_share_above_1e3=flip_share,
        tolerance=tol, deterministic=deterministic,
        # bf16: the image built in the call, as the line always timed it;
        # f32: the image prebuilt (the first SIMT kernels read the packed
        # weights, so both versions time the kernels alone)
        ms=time_ms(lambda: fused_nerf_bwd(
            xyz, ws, bs, dout, n_freqs, dt,
            None if dt == "bfloat16" else image),
            5 if dt == "bfloat16" else reps),
        **({"prev_ms": PREV_F32_BWD_MS.get(n_freqs)} if dt == "float32"
           else {}),
        plain_ms=time_ms(lambda: fused_nerf_bwd_plain(
            xyz, ws, bs, dout, n_freqs, dt), preps, warmup=1),
        # recomputed forward + dgrad + wgrad: 3x the forward's flops
        bound_ms=max(3.0 * flops * M / peak,
                     M * (12 + 16 + 12) / PEAK_BYTES) * 1e3,
        bound_by="operations", **split,
        library_ms=time_ms(lambda: library_mlp_vjp(state, xyz, dout,
                                                   n_freqs, dt), 3,
                           warmup=1),
        library_call=f"library_mlp_vjp: F.linear forward in {dt} (cuBLAS) "
                     "+ torch.autograd.grad")
    del a, a2, b
    return line


def kernel_lines_mlp_bwd_freqs(dev) -> dict:
    """Kernel 6 at the encodings around the flagship's: n_freqs 4 (a
    32-row encoding in the 64-column block) and 16 (104 rows in the
    128-column block), bf16 and f32, each as the 10-frequency lines."""
    import torch

    g = torch.Generator(device=dev).manual_seed(16)
    lines = {}
    for nf in MLP_BWD_FREQS:
        for dt in ("bfloat16", "float32"):
            name = ("fused_mlp_bwd" if dt == "bfloat16"
                    else "fused_mlp_bwd_f32") + f"_n{nf}"
            lines[name] = mlp_bwd_line(dev, g, nf, dt, 20, 3,
                                       profile=dt == "float32")
    return lines


# the MLP backward's other encodings, held and timed beside the flagship's
MLP_BWD_FREQS = (4, 16)

# kernels 3 and 6 in f32 at their edges: a ragged forward (no whole
# number of 64-point blocks) at each encoding block, and a backward over
# two chunks, the second ragged
F32_EDGE_FWD = ((1 << 16) - 37, (4, 16, 21))
F32_EDGE_BWD = ((1 << 19) + 4099, 10)


def mlp_f32_edge_lines(dev) -> dict:
    """Kernel 3 in f32 at F32_EDGE_FWD's points and n_freqs 4, 16 and 21
    (encoding blocks of 64, 128 and 192 columns) on seeded weights and
    biases, within 1e-4 of its plain version (|d| / (1 + |plain|)), rows
    4..7 zero; kernel 6 in f32 over F32_EDGE_BWD's points (BWD_CHUNK and a
    ragged second chunk) at 10 frequencies, within MLP_BWD_TOLS["float32"]
    of its plain version and bit-equal across two launches."""
    import torch

    from animnerf_tpu_torch.models.nerf import NeRFMLP
    from animnerf_tpu_torch.ops.fused_mlp import (
        f32_smem,
        fused_nerf_bwd,
        fused_nerf_bwd_plain,
        fused_nerf_fwd,
        fused_nerf_fwd_plain,
        pack_params,
    )

    g = torch.Generator(device=dev).manual_seed(17)
    lines = {}

    def seeded(nf):
        torch.manual_seed(nf)
        mlp = NeRFMLP(nf, "float32").to(dev)
        for m in mlp.children():
            torch.nn.init.normal_(m.bias, std=0.1)
        return pack_params({k: v.detach() for k, v in
                            mlp.state_dict().items()}, nf, "float32")

    M, freqs = F32_EDGE_FWD
    x = torch.zeros(1, 8, M, device=dev)
    x[0, :3] = 0.4 * torch.randn(3, M, generator=g, device=dev)
    for nf in freqs:
        ws, bs = seeded(nf)
        o = fused_nerf_fwd(x, ws, bs, nf, "float32")
        op = fused_nerf_fwd_plain(x, ws, bs, nf, "float32")
        torch.cuda.synchronize()
        err = float(((o - op).abs() / (1.0 + op.abs())).max())
        check(err <= 1e-4 and bool((o[0, 4:] == 0).all()),
              f"fused_mlp f32 edge n_freqs {nf}: rel err {err}")
        lines[f"fused_mlp_f32_n{nf}_ragged"] = dict(
            shape=f"rows (1,8,{M}), seeded weights and biases",
            block=f32_smem(nf)[0], max_rel_err=err, tolerance=1e-4)
    M, nf = F32_EDGE_BWD
    ws, bs = seeded(nf)
    xyz = torch.zeros(1, 8, M, device=dev)
    xyz[0, :3] = 0.3 * torch.randn(3, M, generator=g, device=dev)
    dout = torch.zeros(1, 8, M, device=dev)
    dout[0, :4] = 1e-3 * torch.randn(4, M, generator=g, device=dev)
    a = fused_nerf_bwd(xyz, ws, bs, dout, nf, "float32")
    a2 = fused_nerf_bwd(xyz, ws, bs, dout, nf, "float32")
    b = fused_nerf_bwd_plain(xyz, ws, bs, dout, nf, "float32")
    torch.cuda.synchronize()
    outs, outs2, ref = ((t[0],) + t[1] + t[2] for t in (a, a2, b))
    outs, outs2, ref = list(outs), list(outs2), list(ref)
    deterministic = all(torch.equal(u, v) for u, v in zip(outs, outs2))
    rel = max(float((u - v).norm() / max(float(v.norm()), 1e-30))
              for u, v in zip(outs, ref))
    pt = ((a[0][0, :3] - b[0][0, :3]).norm(dim=0)
          / (b[0][0, :3].norm(dim=0) + 1e-12))
    tol = MLP_BWD_TOLS["float32"]
    line = dict(shape=f"rows (1,8,{M}) dout (1,8,{M}), seeded weights and "
                      "biases, two chunks",
                max_rel_l2=rel, median_point_rel=float(pt.median()),
                point_share_above_1e3=float((pt > 1e-3).float().mean()),
                tolerance=tol, deterministic=deterministic)
    check(deterministic and rel <= tol["rel_l2"]
          and line["median_point_rel"] <= tol["median_point"]
          and line["point_share_above_1e3"] <= tol["flip_share"],
          f"fused_mlp_bwd f32 edge: {line}")
    lines["fused_mlp_bwd_f32_two_chunks"] = line
    return lines


def _library_mlp(p: dict, x, n_freqs: int = 10, dtype: str = "bfloat16"):
    """The MLP on point-major coordinates x (M, 3) as PyTorch's own ops:
    the encoding and ``torch.nn.functional.linear`` in the compute dtype
    (cuBLAS), the sigma and rgb heads in f32; p: {layer: (weight, bias)}
    -> (M, 4)."""
    import torch

    from animnerf_tpu_torch.models.embedding import positional_encoding

    bf = getattr(torch, dtype)
    enc = positional_encoding(x, n_freqs).to(bf)

    def lin(h, n, dt=bf):
        return torch.nn.functional.linear(h.to(dt), p[n][0].to(dt),
                                          p[n][1].to(dt))

    h = enc
    for i in range(8):
        h = torch.relu(lin(torch.cat([enc, h], -1) if i == 4 else h,
                           f"xyz_{i}"))
    hd = torch.relu(lin(lin(h, "xyz_final"), "dir_0"))
    return torch.cat([torch.sigmoid(lin(hd, "rgb", torch.float32)),
                      lin(h, "sigma", torch.float32)], -1)


MLP_LAYERS = [f"xyz_{i}" for i in range(8)] + ["sigma", "xyz_final", "dir_0",
                                               "rgb"]


def library_mlp_fwd(state: dict, xyz, n_freqs: int = 10,
                    dtype: str = "bfloat16"):
    """Kernel 3's library yardstick: ``_library_mlp`` in dtype on the
    coordinates of rows (1, 8, M), no gradient."""
    import torch

    with torch.no_grad():
        return _library_mlp({n: (state[f"{n}.weight"], state[f"{n}.bias"])
                             for n in MLP_LAYERS}, xyz[0, 0:3].t(), n_freqs,
                            dtype)


def library_mlp_vjp(state: dict, xyz, dout, n_freqs: int = 10,
                    dtype: str = "bfloat16"):
    """One call of the MLP's VJP as PyTorch's own ops: ``_library_mlp``,
    then ``torch.autograd.grad`` to the coordinates and every weight and
    bias. The library yardstick of the fused backward; its rounding points
    are cuBLAS's, not the TPU kernel's."""
    import torch

    p = {n: (state[f"{n}.weight"].detach().requires_grad_(),
             state[f"{n}.bias"].detach().requires_grad_())
         for n in MLP_LAYERS}
    x = xyz[0, 0:3].t().detach().requires_grad_()
    out = _library_mlp(p, x, n_freqs, dtype)
    return torch.autograd.grad(out, [x] + [t for n in MLP_LAYERS
                                           for t in p[n]],
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
        HEAD_COLS,
        WGRAD_LAYERS,
        fused_nerf_bwd_buffers,
        fused_nerf_wgrad,
        pack_params,
        bwd_layout,
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
            H, G = scratch_views(scratch, chunk, bwd_layout(10).cols)
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
                bound_ms=bound, bound_by="bytes", pct_of_bound=100.0 * bound / ms,
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
# the edge lines of kernels 8 and 9 above 16 neighbours: each list size of
# the warp-per-point kernels (32, 64 and 128 slots; kernel 9 holds k + 1)
EDGE_WIDE_KS = (24, 33, 40, 64)
# kernel 9's: fewer points (its plain version loops k x V / 512 times a
# chunk)
EDGE_WIDE_EXACT_POINTS = (1 << 16) - 37


def kernel_lines_edge(dev):
    """Kernels 1 and 8 at the shapes their sweep's tiling stresses:
    N = 2^20 - 37 points, V in {K, 1025, 8192} vertices (one padded tile;
    one real row in the last tile; the index field's limit), K in {1, 4,
    8, 16}, kernel 1 (K = 4) with and without its tile skip; seeded clouds
    (normal, 0.3 m) and points near them (0.05 m); then kernel 8's
    warp-per-point kernel at K in EDGE_WIDE_KS on V = K, 1025 and 8192,
    and on the 1/64-grid tie cloud at K = 40 and 64. Each output bit-equal
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
    # the warp-per-point kernel (knn_packed_wide), each register list's
    # size: V = K, one real row in the last tile, the index field's limit;
    # then the 1/64-grid tie cloud
    clouds = []
    for V in EDGE_WIDE_KS + (1025, 8192):
        verts = 0.3 * torch.randn(1, V, 3, generator=g, device=dev)
        pick = torch.randint(0, V, (N,), generator=g, device=dev)
        pts = (verts[0, pick]
               + 0.05 * torch.randn(N, 3, generator=g, device=dev))[None]
        clouds.append(("normal", V, verts, pts.contiguous(),
                       [K for K in EDGE_WIDE_KS if K == V or V > 64]))
    clouds.append(("grid", 6890, morton_sorted(torch.randint(
        -48, 49, (1, 6890, 3), generator=g, device=dev).float() / 64),
        torch.randint(-56, 57, (1, N, 3), generator=g,
                      device=dev).float() / 64, [40, 64]))
    for cloud, V, verts, pts, ks in clouds:
        for K in ks:
            lines[f"knn_packed_{cloud}_k{K}_v{V}"] = packed_wide_line(
                pts, verts, K, 3, timed=False)
    return lines


def kernel_lines_edge_scatter_warp(dev):
    """Kernels 5 and 2 at the shapes their designs stress. The scatter at
    K in {1, 4, 8, 16} with one radix pass (B V = 300), two (B V = 13,780,
    N = 20,011: a ragged last tile) and three (B V = 275,600 > 2^18), half
    of the first neighbours on one row, zero weights and zero cotangent
    columns: each bit-equal to its plain version and to a second run. The
    warp-blend (``edge_warp_line``) at K in {1, 4, 8, 16} and EDGE_WIDE_KS
    (the latter also with ``warp_view``) on each family's row (LBS part 5,
    16, 24, 52, 55: FLAME, MANO, SMPL, SMPL-H, SMPL-X; padded to 4 floats
    where it is not a multiple) and on an SMPL table 4 bytes off 16-byte
    alignment (padded too), one-hot LBS columns so that several neighbours
    blend; at EDGE_WIDE_KS also on a table of V = K rows."""
    import torch

    from animnerf_tpu_torch.ops.blend import (
        radix_passes,
        weighted_scatter_rows,
        weighted_scatter_rows_plain,
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
        for K in (1, 4, 8, 16) + EDGE_WIDE_KS:
            idx = torch.randint(0, V, (1, K, N), generator=g, device=dev,
                                dtype=torch.int32)
            views = (False, True) if K in EDGE_WIDE_KS else (False,)
            for view in views:
                lines[f"warp_blend_k{K}_f{F}{'' if aligned else '_off16'}"
                      f"{'_view' if view else ''}"] = edge_warp_line(
                    g, idx, table, num_lbs, view)
    # V = K: every vertex a neighbour of every point, in random order
    table = torch.randn(1, 64, 40, generator=g, device=dev)
    table[0, :, :24] = torch.nn.functional.one_hot(torch.randint(
        0, 3, (64,), generator=g, device=dev), 24).float()
    for K in EDGE_WIDE_KS:
        idx = torch.argsort(torch.rand(1, K, N, generator=g, device=dev),
                            dim=1).to(torch.int32)
        lines[f"warp_blend_k{K}_v{K}"] = edge_warp_line(
            g, idx, table[:, :K].contiguous(), 24, False)
    return lines


def edge_warp_line(g, idx, table, num_lbs: int, warp_view: bool) -> dict:
    """Kernel 2 at an edge shape (the neighbours idx (1, K, N) of table,
    sorted random distances, random xyz and, with ``warp_view``, view rows):
    within 1e-4 of its plain version, the residual-free out bit-equal to
    the full mode's, and above WARP_GROUP_ABOVE (the group kernel) bit-equal
    to the thread route."""
    import torch

    from animnerf_tpu_torch.ops.warp_blend import (
        group_route,
        warp_blend_fwd,
        warp_blend_fwd_plain,
    )

    _, K, N = idx.shape
    dev = idx.device
    d = torch.rand(1, K, N, generator=g, device=dev).sort(1)[0]
    rows = torch.zeros(1, 8, N, device=dev)
    rows[0, :3] = torch.randn(3, N, generator=g, device=dev)
    if warp_view:
        rows[0, 4:7] = torch.randn(3, N, generator=g, device=dev)
    args = (rows, d.contiguous(), idx, table, num_lbs, 0.1, 0.9)
    kw = {"warp_view": warp_view}
    out = warp_blend_fwd(*args, **kw)
    outp = warp_blend_fwd_plain(*args, **kw)
    o = warp_blend_fwd(*args, residuals=False, **kw)[0]
    old = warp_blend_fwd(*args, route="thread", **kw)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, outp))
    same = bool(torch.equal(o, out[0]))
    group = group_route(None, K, num_lbs)
    thread_equal = all(torch.equal(a, b) for a, b in zip(out, old))
    check(err <= 1e-4 and same and thread_equal,
          f"edge warp_blend K={K} table {tuple(table.shape)} num_lbs="
          f"{num_lbs} view={warp_view}: max err {err}, residual-free out "
          f"bit-equal {same}, bit-equal to the thread route {thread_equal}")
    return dict(shape=f"knn (1,{K},{N}) table {tuple(table.shape)}"
                      f"{' warp_view' if warp_view else ''}",
                route="group" if group else "thread", max_abs_err=err,
                tolerance=1e-4, out_only_bit_equal=same,
                bit_equal_to_thread=thread_equal)


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
    cloud, vertices and points on a 1/64 grid, at K = 4 and 16. Then the
    warp-per-point kernel on EDGE_WIDE_EXACT_POINTS points at K in
    EDGE_WIDE_KS: V = K, 513, 8193, 10475 and the grid cloud at K = 40 and
    64. Each output, with and without the cull, bit-equal to
    knn_exact_plain, and the rows kernel's rows and boxes to
    exact_rows_plain's."""
    import torch

    from animnerf_tpu_torch.ops.knn_kernel import (
        EXACT_WIDE_ABOVE,
        exact_rows,
        exact_rows_plain,
    )

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
    # the warp-per-point kernel (knn_exact_wide): V = K, one real vertex in
    # the last tile, above the packed limit, SMPL-X; the tie cloud, most of
    # whose points take the slot rule after the nearest-first pass
    n = EDGE_WIDE_EXACT_POINTS
    for V in EDGE_WIDE_KS + (513, 8193, 10475):
        verts = morton_sorted(0.3 * torch.randn(1, V, 3, generator=g,
                                                device=dev))
        pick = torch.randint(0, V, (n,), generator=g, device=dev)
        pts = morton_sorted((verts[0, pick] + 0.05 * torch.randn(
            n, 3, generator=g, device=dev))[None])
        ks = {513: [33, 64], 8193: [40], 10475: [24, 40, 64]}.get(V, [V])
        clouds.append(("normal", V, verts, pts, ks))
    clouds.append(("grid", 10475, grid_v, grid_p[:, :n].contiguous(),
                   [40, 64]))
    lines = {}
    for cloud, V, verts, pts, ks in clouds:
        rows_equal = all(torch.equal(a, b) for a, b in
                         zip(exact_rows(verts), exact_rows_plain(verts)))
        check(rows_equal, f"edge V={V}: exact rows kernel differs from plain")
        for K in ks:
            lines[f"knn_exact_{cloud}_k{K}_v{V}"] = dict(
                shape=f"points {tuple(pts.shape)} verts (1,{V},3) K={K}",
                **exact_check(pts, verts, K), rows_bit_equal=rows_equal,
                instantiation=knn_instantiation(9, K),
                **(exact[K] if K <= EXACT_WIDE_ABOVE else {}))
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
    PyTorch counterpart: library_ms times the composites cdist then topk
    (amin), by chunks of points."""
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
        bound_by="operations", library_ms=library_min_dist_ms(pts, verts),
        library_call="torch.cdist + amin, 32768-point chunks")
    return lines


# the neighbour counts above 16 of kernel 5
WIDE_KS = (17, 24, 32, 40)
# kernel 2's: its group kernel above ops/warp_blend.py WARP_GROUP_ABOVE,
# held bit for bit to the thread route there (the run-time-k kernel)
WARP_WIDE_KS = (17, 24, 32, 40, 64, 128)
# kernel 2's routes timed either side of the threshold ("warp_routes")
WARP_ROUTE_KS = (8, 12, 16, 17)
# kernels 8 and 9: either side of the threshold (ops/knn_kernel.py
# PACKED_WIDE_ABOVE, EXACT_WIDE_ABOVE), of each register list's size and of
# the cap (knn_wide::CAP), and one k above it (the global-memory versions)
WIDE_KNN_KS = (17, 24, 32, 33, 40, 64, 128, 160)
# kernel 9's wide lines: points of the SMPL-X cloud (its plain version
# loops k x V / 512 times a chunk, so fewer than the K = 4, 8 lines' 2^20)
WIDE_EXACT_POINTS = 1 << 18
# from this k on, both kernels' wide lines take WIDE_BIG_K_POINTS points
# (the plain versions' loops and the global-memory versions grow with k)
WIDE_BIG_K = 64
WIDE_BIG_K_POINTS = 1 << 16


def smpl_wide_cloud(dev, g):
    """The wide-K lines' SMPL cloud, drawn from g: the posed seed-0 rig's
    Morton-ordered vertices (1, 6890, 3), 2^20 points around them in
    random order, their (1, 8, N) rows, and the rig's table with one-hot
    LBS columns (so that several neighbours pass the gate) -> (verts, pts,
    rows, table, J)."""
    import torch

    from animnerf_tpu_torch.data.synthetic import random_pose_params
    from animnerf_tpu_torch.models.warp import prepare_frame

    pose = random_pose_params(24, batch=1, seed=4)
    tmpl = random_pose_params(24, batch=1, seed=2)
    tmpl["transl"] = np.zeros_like(tmpl["transl"])
    with torch.no_grad():
        ctx = prepare_frame(smpl_rig().to(dev), tensors(pose, dev),
                            tensors(tmpl, dev))
    verts = ctx.verts_morton.contiguous()
    V, J = verts.shape[1], ctx.lbs_weights.shape[1]
    N = 1 << 20
    pick = torch.randint(0, V, (N,), generator=g, device=dev)
    pts = (verts[0, pick] + 0.05 * torch.randn(N, 3, generator=g,
                                               device=dev))[None]
    rows = torch.nn.functional.pad(pts.transpose(1, 2),
                                   (0, 0, 0, 5)).contiguous()
    table = ctx.table_morton.clone()
    table[..., :J] = torch.nn.functional.one_hot(
        table[..., :J].argmax(-1), J).to(table.dtype)
    return verts, pts, rows, table, J


def warp_blend_bound_ms(args) -> float:
    """Kernel 2's bound on (rows, dists, idx, table, ...) without the view
    direction: the inputs once (3 xyz floats, K distances and indices a
    point, the table) and the full mode's outputs once (8 + K + 16 floats
    a point), or its f32 operations, the larger."""
    rows, d, idx, table, J = args[:5]
    B, K, N = idx.shape
    nbytes = (3 * B * N + 2 * d.numel() + table.numel()
              + B * N * (8 + K + 16)) * 4
    return max(nbytes / PEAK_BYTES,
               B * N * (K * (3 * J + 40) + 100) / PEAK_F32) * 1e3


def warp_wide_line(args: tuple, reps: int, preps: int,
                   cut: str = "") -> dict:
    """Kernel 2 on (rows, dists, idx, table, num_lbs, std, gate) at wide K:
    the route warp_blend_fwd takes (the group kernel above
    WARP_GROUP_ABOVE) bit-equal to the thread route, within
    1e-4 of the plain version (every output), its residual-free out
    bit-equal to the full mode's; both routes' times, the residual-free
    time, the bound and its share, the gathered table bytes."""
    import torch

    from animnerf_tpu_torch.ops.warp_blend import (
        group_route,
        warp_blend_fwd,
        warp_blend_fwd_plain,
    )

    rows, d, idx, table, J = args[:5]
    B, K, N = idx.shape
    out = warp_blend_fwd(*args)
    old = warp_blend_fwd(*args, route="thread")
    outp = warp_blend_fwd_plain(*args)
    o = warp_blend_fwd(*args, residuals=False)[0]
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, outp))
    same = all(torch.equal(a, b) for a, b in zip(out, old))
    tol = 1e-4
    check(err <= tol and same and torch.equal(o, out[0]),
          f"warp_blend K={K}: max err {err} > {tol}, bit-equal to the "
          f"thread route {same}, or the residual-free out differs")
    multi = float((out[1][:, 1:] > 0).any(dim=1).float().mean())
    check(multi > 0.1, f"warp_blend K={K}: only {multi} of the points "
          "blend more than one neighbour")
    del out, old, outp, o
    line = dict(
        shape=f"rows ({B},8,{N}) knn ({B},{K},{N}) table "
              f"{tuple(table.shape)} one-hot LBS{cut}",
        route="group" if group_route(None, K, J) else "thread",
        max_abs_err=err, tolerance=tol, bit_equal_to_thread=same,
        out_only_bit_equal=True, share_blending_2_or_more=multi,
        gathered_bytes=B * N * K * table.shape[2] * 4,
        ms=time_ms(lambda: warp_blend_fwd(*args), reps),
        thread_ms=time_ms(lambda: warp_blend_fwd(*args, route="thread"),
                          reps),
        out_only_ms=time_ms(lambda: warp_blend_fwd(*args, residuals=False),
                            reps),
        plain_ms=time_ms(lambda: warp_blend_fwd_plain(*args), preps),
        bound_ms=warp_blend_bound_ms(args), bound_by="bytes",
        library_ms=None, library_call=WARP_BLEND_LIBRARY)
    line["pct_of_bound"] = 100.0 * line["bound_ms"] / line["ms"]
    return line


def warp_route_times(args: tuple, reps: int) -> dict:
    """Kernel 2's routes on one call's arguments: the thread kernels and
    the group kernel, its outputs compared bit for bit with the thread
    route's."""
    import torch

    from animnerf_tpu_torch.ops.warp_blend import warp_blend_fwd

    old = warp_blend_fwd(*args, route="thread")
    got = warp_blend_fwd(*args, route="group")
    torch.cuda.synchronize()
    return dict(
        group_bit_equal=all(torch.equal(a, b) for a, b in zip(got, old)),
        thread_ms=time_ms(lambda: warp_blend_fwd(*args, route="thread"),
                          reps),
        group_ms=time_ms(lambda: warp_blend_fwd(*args, route="group"),
                         reps))


def warp_routes(ck, bp, tmpl) -> dict:
    """Kernel 2's routes either side of WARP_GROUP_ABOVE (WARP_ROUTE_KS)
    on two shapes: the wide-K lines' 2^20 random-order SMPL cloud with the
    packed kNN's K neighbours, and the first warp-blend call of view 29 at
    512x512 with k_neigh K (the scale512 weights on the one-hot rig), in
    ray order. The group kernel must be bit-equal to the thread route at
    every K."""
    import torch

    from animnerf_tpu_torch.ops.knn_kernel import knn_packed
    from animnerf_tpu_torch.ops.warp_blend import GROUP_LANES, WARP_GROUP_ABOVE

    g = torch.Generator(device="cuda").manual_seed(24)
    verts, pts, rows, table, J = smpl_wide_cloud("cuda", g)
    out = {"threshold": WARP_GROUP_ABOVE, "group_lanes": GROUP_LANES}
    for K in WARP_ROUTE_KS:
        d, i = knn_packed(pts, verts, K)
        system = scale512_system(ck, "cuda", rigid=True, k_neigh=K)
        call = capture_warp_blend(view_fn(system, bp, tmpl, 29))[0]["args"]
        del system
        res = {}
        for shape, args in (("random_order", (rows, d, i, table, J, 0.1,
                                              0.9)),
                            ("view_ray_order", call)):
            res[shape] = dict(points=int(args[2].shape[2]),
                              **warp_route_times(args, 10))
            check(res[shape]["group_bit_equal"],
                  f"warp_routes K={K} {shape}: the group kernel "
                  "differs from the thread route")
        out[K] = res
        del d, i, call
    torch.cuda.empty_cache()
    return out


def knn_instantiation(kernel: int, k: int) -> str:
    """The kernel kernel 8 or 9 launches at k on knn's own route."""
    from animnerf_tpu_torch.ops import knn_kernel as kk

    above = kk.PACKED_WIDE_ABOVE if kernel == 8 else kk.EXACT_WIDE_ABOVE
    if k <= above:
        return ("sweep_kernel" if kernel == 8 else "knn_exact_kernel") \
            + f"<K={k}>"
    name = "knn_packed" if kernel == 8 else "knn_exact"
    if k > kk.WIDE_CAP:
        return f"{name}_any (run-time k, slots in global memory)"
    slots = k + 1 if kernel == 9 and k < kk.WIDE_CAP else k
    return f"{name}_wide<R={1 if slots <= 32 else 2 if slots <= 64 else 4}>"


def packed_wide_line(pts, verts, k: int, reps: int,
                     timed: bool = True) -> dict:
    """Kernel 8 at k on knn's route, bit-equal to its plain version: time,
    the share of pairs swept (the wide route's stats) and (``timed``)
    bounds for the swept pairs (bound_ms) and all pairs (bound_all_ms),
    the plain version's and the library composite's times."""
    import torch

    from animnerf_tpu_torch.ops import knn_kernel as kk

    B, N, V = pts.shape[0], pts.shape[1], verts.shape[1]
    d, i = kk.knn_packed(pts, verts, k)
    dp, ip = kk.knn_packed_plain(pts, verts, k, PLAIN_MAX_ELEMS)
    torch.cuda.synchronize()
    mism = int((i != ip).sum())
    err = float((d - dp).abs().max())
    check(mism == 0 and torch.equal(d, dp),
          f"knn_packed K={k} {tuple(pts.shape)}: {mism} index mismatches, "
          f"max err {err}")
    share = 1.0
    if kk.PACKED_WIDE_ABOVE < k <= kk.WIDE_CAP:
        stats = torch.zeros(2, dtype=torch.int64, device=pts.device)
        kk.knn_packed(pts, verts, k, stats=stats)
        swept, skipped = (int(x) for x in stats.tolist())
        share = swept / max(swept + skipped, 1)
    nbytes = B * (N * 12 + V * 12 + N * 8 * k)
    line = dict(
        shape=f"points {tuple(pts.shape)} verts {tuple(verts.shape)} K={k}",
        max_abs_err=err, tolerance=0.0, idx_mismatch=mism,
        instantiation=knn_instantiation(8, k), swept_share=share,
        ms=time_ms(lambda: kk.knn_packed(pts, verts, k), reps))
    if not timed:
        return line
    line.update(
        plain_ms=time_ms(lambda: kk.knn_packed_plain(pts, verts, k,
                                                     PLAIN_MAX_ELEMS), 1),
        bound_ms=knn_bound_ms(B * N * V * share, nbytes),
        bound_all_ms=knn_bound_ms(B * N * V, nbytes), bound_by="operations",
        library_ms=library_knn_ms(pts, verts, k),
        library_call="torch.cdist + torch.topk, 32768-point chunks")
    line["pct_of_bound"] = 100.0 * line["bound_ms"] / line["ms"]
    line["pct_of_bound_all"] = 100.0 * line["bound_all_ms"] / line["ms"]
    return line


def route_times(fn, pts, verts, k: int, reps: int) -> dict:
    """Kernel 8 or 9 (fn) at k up to its threshold on both routes: the
    outputs bit-equal, each route's ms."""
    import torch

    a, b = fn(pts, verts, k, route="wide"), fn(pts, verts, k, route="sweep")
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          f"{fn.__name__} K={k} {tuple(pts.shape)}: the routes differ")
    return {r: time_ms(lambda: fn(pts, verts, k, route=r), reps)
            for r in ("wide", "sweep")}


def kernel_lines_wide_k(dev, exact: dict) -> dict:
    """Kernels 8 and 9 at K in WIDE_KNN_KS, 2 and 5 at K in WIDE_KS, each
    against its plain version: the packed kNN on 2^20 points around the
    posed seed-0 SMPL rig and kernel 9 on WIDE_EXACT_POINTS around the
    SMPL-X rig (from WIDE_BIG_K on, the first WIDE_BIG_K_POINTS of each),
    both bit-equal (kernel 9 with and without its cull), with the kernel
    that ran, its swept share and both bounds; "knn_routes": both routes'
    times where the per-K instantiations end (kernel 9 also at 17) on
    those points and on a second shape (kernel 8: the training batch
    (16, 32768); kernel 9: the same points in Morton order), the outputs
    bit-equal across the routes; the warp-blend on
    the packed kNN's K neighbours (K in WARP_WIDE_KS, ``warp_wide_line``);
    the scatter at the training step's (16, K, 32768) ->
    (16, 6890, 16), bit-equal and within the K = 8 line's tolerance.
    Times, bounds and library calls as the K = 4 and 8 lines'."""
    import torch

    from animnerf_tpu_torch.models.warp import prepare_frame
    from animnerf_tpu_torch.ops.blend import (
        weighted_scatter_rows,
        weighted_scatter_rows_plain,
    )
    from animnerf_tpu_torch.ops.knn_kernel import (
        EXACT_WIDE_ABOVE,
        PACKED_WIDE_ABOVE,
        knn_exact,
        knn_packed,
    )

    g = torch.Generator(device=dev).manual_seed(24)
    reps, preps = 5, 1
    lines = {}
    verts, pts, rows, table, J = smpl_wide_cloud(dev, g)
    V, N = verts.shape[1], pts.shape[1]
    with torch.no_grad():
        xctx = prepare_frame(smplx_rig().to(dev),
                             tensors(smplx_params(1, 1), dev),
                             tensors(smplx_params(1, 2, zero_transl=True),
                                     dev))
    xverts = xctx.verts_morton.contiguous()
    xpick = torch.randint(0, xverts.shape[1], (WIDE_EXACT_POINTS,),
                          generator=g, device=dev)
    xpts = (xverts[0, xpick] + 0.1 * torch.randn(
        WIDE_EXACT_POINTS, 3, generator=g, device=dev))[None].contiguous()
    B, NS = 16, 32768
    spick = torch.randint(0, V, (B, NS), generator=g, device=dev)
    spts = (verts[0, spick] + 0.1 * torch.randn(B, NS, 3, generator=g,
                                                device=dev))
    sverts = verts.expand(B, V, 3).contiguous()
    gr = torch.randn(B, 16, NS, generator=g, device=dev)
    # the thresholds: both routes where the per-K instantiations end (and
    # kernel 9 at 17), on two shapes a kernel
    xpts_m = morton_sorted(xpts)
    lines["knn_routes"] = {
        "thresholds": {"knn_packed": PACKED_WIDE_ABOVE,
                       "knn_exact": EXACT_WIDE_ABOVE},
        "knn_packed": {PACKED_WIDE_ABOVE: {
            "random_order": route_times(knn_packed, pts, verts,
                                        PACKED_WIDE_ABOVE, reps),
            "training_batch": route_times(knn_packed, spts, sverts,
                                          PACKED_WIDE_ABOVE, reps)}},
        "knn_exact": {K: {
            "random_order": route_times(knn_exact, xpts, xverts, K, reps),
            "morton_order": route_times(knn_exact, xpts_m, xverts, K, reps)}
            for K in (17, EXACT_WIDE_ABOVE)}}
    for K in WIDE_KNN_KS:
        # -- kernels 8 and 9 (from WIDE_BIG_K on fewer points)
        few = K >= WIDE_BIG_K
        p8 = pts[:, :WIDE_BIG_K_POINTS] if few else pts
        p9 = xpts[:, :WIDE_BIG_K_POINTS] if few else xpts
        lines[f"knn_packed_k{K}"] = packed_wide_line(p8, verts, K, reps)
        lines[f"knn_exact_k{K}"] = dict(
            exact_line(p9, xverts, K, exact if K <= EXACT_WIDE_ABOVE else {},
                       reps=reps), instantiation=knn_instantiation(9, K))
        if K in WARP_WIDE_KS:
            # -- kernel 2 on those neighbours (from WIDE_BIG_K on, fewer)
            n2 = WIDE_BIG_K_POINTS if few else N
            d, i = knn_packed(pts[:, :n2], verts, K)
            lines[f"warp_blend_k{K}"] = warp_wide_line(
                (rows[..., :n2].contiguous(), d, i, table, J, 0.1, 0.9),
                reps, preps, " (2^16 points)" if few else "")
            del d, i
        if K not in WIDE_KS:
            continue
        # -- kernel 5 at the training step's shape
        _, si = knn_packed(spts, sverts, K)
        w = torch.rand(B, K, NS, generator=g, device=dev)
        w = (w / w.sum(1, keepdim=True)).contiguous()
        out = weighted_scatter_rows(si, w, gr, V)
        out2 = weighted_scatter_rows(si, w, gr, V)
        outp = weighted_scatter_rows_plain(si, w, gr, V)
        torch.cuda.synchronize()
        err = float((out - outp).abs().max())
        tol = 1e-5 * float(outp.abs().max())
        same, det = bool(torch.equal(out, outp)), bool(torch.equal(out, out2))
        check(err <= tol and same and det, f"scatter K={K}: max err {err} "
              f"> {tol}, bit-equal {same}, deterministic {det}")
        flat = torch.zeros(B * V, 16, device=dev)
        contrib = (w[:, :, None, :] * gr[:, None]).permute(0, 1, 3, 2) \
            .reshape(-1, 16).contiguous()
        srows = (si.long() + (torch.arange(B, device=dev) * V)[:, None, None]
                 ).reshape(-1)
        lines[f"scatter_k{K}"] = dict(
            shape=f"idx/w ({B},{K},{NS}) g ({B},16,{NS}) -> ({B},{V},16)",
            max_abs_err=err, tolerance=tol, deterministic=det,
            bit_equal_to_plain=same,
            ms=time_ms(lambda: weighted_scatter_rows(si, w, gr, V), reps),
            plain_ms=time_ms(lambda: weighted_scatter_rows_plain(
                si, w, gr, V), preps),
            bound_ms=B * (NS * (K + K + 16) * 4 + V * 16 * 4)
            / PEAK_BYTES * 1e3, bound_by="bytes",
            library_ms=deterministic_scatter_ms(flat, srows, contrib, reps),
            library_call="index_put_(accumulate=True), deterministic "
                         "algorithms")
        del si, w, out, out2, outp, contrib, srows, flat
    return lines


def mxu_sass(funcs: dict) -> dict:
    """Instruction counts of kernel 10's SASS (csrc/knn_mxu.cu
    knn_mxu_mma_kernel<KC>, KC = 1 "default", 2 "highest"): its tensor-core
    products (HMMA) and local-memory spills (STL / LDL)."""
    import re

    out = {}
    for name, ins in funcs.items():
        m = re.search(r"knn_mxu_mma_kernelILi(\d)E", name)
        if m:
            out[f"KC={m.group(1)}"] = {
                op: sum(t.split()[0].split(".")[0] == op for _, t in ins)
                for op in ("HMMA", "STL", "LDL")}
    return out


def mxu_pair_d2(P, A, b, n, v):
    """The plain version's d2 of the pairs (b, n, v) (index tensors of one
    shape): the rows P (B, 8, N) and A (B, V, 8) multiplied and summed left
    to right, each operation rounded on its own (``mxu_d2``'s order)."""
    Pg, Ag = P[b, :, n], A[b, v]
    d2 = Ag[..., 0] * Pg[..., 0]
    for col in range(1, 8):
        d2 = d2 + Ag[..., col] * Pg[..., col]
    return d2


def mxu_check(pts, verts, got, want, precision: str) -> dict:
    """Kernel 10's outputs got = (d, i) against its plain version's want,
    both (B, N, 4) ascending: (a) the squared distances slot by slot
    within eps (``ops/knn_mxu.py::mxu_eps``, plus 2^-21 of d2 for the
    square root's rounding), (b) where an index differs, the plain d2s of
    the two candidates within 2 eps of each other. Returns the largest
    deviation and its share of eps, the index mismatches, how many of them
    are near-ties (within 2 eps) and exact ties, and "ok"."""
    import torch

    from animnerf_tpu_torch.ops.knn_mxu import (
        EPS_SCALE,
        augmented_rows,
        mxu_eps,
    )

    (d, i), (dp, ip) = got, want
    eps = mxu_eps(pts, verts)[..., None]
    d2, d2p = d.double() ** 2, dp.double() ** 2
    dev_a = (d2 - d2p).abs()
    ok_a = bool((dev_a <= eps + 2.0 ** -21 * torch.maximum(d2, d2p)).all())
    P, A = augmented_rows(pts, verts)
    if precision == "default":
        P = P.to(torch.bfloat16).float()
        A = A.to(torch.bfloat16).float()
    b, n, slot = (i != ip).nonzero(as_tuple=True)
    gap = (mxu_pair_d2(P, A, b, n, i[b, n, slot].long()).double()
           - mxu_pair_d2(P, A, b, n, ip[b, n, slot].long()).double()).abs()
    near = gap <= 2 * eps[b, n, 0]
    return dict(eps_scale=EPS_SCALE, eps_max=float(eps.max()),
                max_d2_dev=float(dev_a.max()),
                max_d2_dev_over_eps=float((dev_a / eps).max()),
                max_abs_err=float((d - dp).abs().max()),
                idx_mismatch=int(b.numel()),
                mismatch_near_ties=int(near.sum()),
                mismatch_exact_ties=int((gap == 0).sum()),
                ok=ok_a and bool(near.all()))


def mxu_bound_ms(B: int, N: int, V: int, precision: str) -> dict:
    """Kernel 10's bounds: the live bf16 products' flops (2 x 5 a pair at
    "default", 2 x 30 at "highest"; the kernel's padding to a depth of 16
    / 32 is not counted) at the bf16 tensor-core rate, one compare a pair
    at the non-FMA f32 rate and the bytes (points, vertices and outputs
    once), the largest; and the SIMT form's (8 multiply-adds a pair at the
    f32 FMA rate), the bound before the tensor cores, kept for the table's
    history."""
    from animnerf_tpu_torch.ops.knn_mxu import LIVE

    pairs = float(B) * N * V
    nbytes = B * (N * 12 + V * 12 + N * 32) / PEAK_BYTES
    return dict(bound_ms=max(2.0 * LIVE[precision] * pairs / PEAK_BF16,
                             pairs / PEAK_F32_NONFMA, nbytes) * 1e3,
                bound_simt_ms=max(16.0 * pairs / PEAK_F32,
                                  pairs / PEAK_F32_NONFMA, nbytes) * 1e3)


def kernel_lines_mxu(dev, sass: dict):
    """Check and time the matmul-form kNN at the kNN tool's shapes (16 x
    65536 ray-like points, V=6890, the tool's first point set) in both
    precisions, each against its plain version by ``mxu_check``, and the
    same on the 1/64-grid tie cloud (2^16 points, V = 6890), the operands
    the card packs bit-equal to ``mxu_operands`` on both; the restated
    bound, the SIMT one, the SASS's HMMA count. library_ms times the
    composite cdist then topk (one for both precisions)."""
    import torch

    from animnerf_tpu_torch.ops import knn_mxu as mx
    from animnerf_tpu_torch.ops.knn_mxu import (
        knn_mxu,
        knn_mxu_plain,
        mxu_operands,
        mxu_operands_cuda,
    )
    from animnerf_tpu_torch.tools.bench_knn import make_inputs

    verts, sets = make_inputs(16, 65536)
    verts = torch.from_numpy(verts).to(dev)
    pts = torch.from_numpy(sets[0]).to(dev)
    B, N, _ = pts.shape
    V = verts.shape[1]
    g = torch.Generator(device=dev).manual_seed(10)
    gverts = torch.randint(-48, 49, (1, V, 3), generator=g,
                           device=dev).float() / 64
    gpts = torch.randint(-56, 57, (1, 1 << 16, 3), generator=g,
                         device=dev).float() / 64
    lines = {}
    lib_ms = library_knn_ms(pts, verts, 4)
    for prec, name, kc in (("highest", "knn_mxu", "KC=2"),
                           ("default", "knn_mxu_default", "KC=1")):
        for p, v in ((pts, verts), (gpts, gverts)):
            got = mxu_operands_cuda(p, v, prec)
            want = mxu_operands(p, v, prec)
            check(all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                      for a, b in zip(got, want)),
                  f"{name}: the packed operands differ from mxu_operands")
        chk = mxu_check(pts, verts, knn_mxu(pts, verts, 4, prec),
                        knn_mxu_plain(pts, verts, 4, prec,
                                      max_elems=PLAIN_MAX_ELEMS), prec)
        tie = mxu_check(gpts, gverts, knn_mxu(gpts, gverts, 4, prec),
                        knn_mxu_plain(gpts, gverts, 4, prec,
                                      max_elems=PLAIN_MAX_ELEMS), prec)
        check(chk["ok"] and tie["ok"] and sass[kc]["HMMA"] > 0,
              f"{name}: {chk}, tie cloud {tie}, SASS {sass[kc]}")
        stats = torch.zeros(3, dtype=torch.int64, device=dev)
        knn_mxu(pts, verts, 4, prec, stats=stats)
        T = -(-V // 8)  # vertex tiles, two a step
        lines[name] = dict(
            shape=f"points ({B},{N},3) verts ({B},{V},3) precision {prec}",
            **chk, tolerance="eps = 2^-19 (|p| + max|v|)^2 on d2",
            tie_cloud=tie, sass=sass[kc], tiles_per_warp=mx.TILES,
            insert_steps=int(stats[0]), inserts=int(stats[1]),
            warp_steps=B * -(-N // (16 * mx.TILES)) * -(-T // 2),
            operands_ms=time_ms(lambda: mxu_operands_cuda(pts, verts, prec),
                                10),
            ms=time_ms(lambda: knn_mxu(pts, verts, 4, prec), 10),
            plain_ms=time_ms(lambda: knn_mxu_plain(
                pts, verts, 4, prec, max_elems=PLAIN_MAX_ELEMS), 1, warmup=0),
            **mxu_bound_ms(B, N, V, prec), bound_by="operations",
            library_ms=lib_ms,
            library_call="torch.cdist + torch.topk, 32768-point chunks")
        lines[name]["pct_of_bound"] = \
            100.0 * lines[name]["bound_ms"] / lines[name]["ms"]
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
    # kernels 3 and 6 in f32: one register-tiled f32 layer routine
    "fused_mlp_f32": ("animnerf_tpu_torch/csrc/mlp_f32.cu",
                      "animnerf_tpu/ops/fused_mlp.py:182"),
    "fused_mlp_bwd_f32": ("animnerf_tpu_torch/csrc/mlp_f32.cu",
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
    # kernel 2's warp_view option (the view direction warped with the
    # points), on (1, 2^20) points at K = 4 (K = 8 under "k8")
    "warp_blend_view_dir": ("animnerf_tpu_torch/csrc/warp_blend.cu",
                            "animnerf_tpu/ops/warp_blend.py:48"),
    # kernel 6 at the other encoding blocks: n_freqs 4 (64 columns) and 16
    # (128), bf16 and f32
    "fused_mlp_bwd_n4": ("animnerf_tpu_torch/csrc/fused_mlp_bwd.cu",
                         "animnerf_tpu/ops/fused_mlp.py:227"),
    "fused_mlp_bwd_n16": ("animnerf_tpu_torch/csrc/fused_mlp_bwd.cu",
                          "animnerf_tpu/ops/fused_mlp.py:227"),
    "fused_mlp_bwd_f32_n4": ("animnerf_tpu_torch/csrc/mlp_f32.cu",
                             "animnerf_tpu/ops/fused_mlp.py:227"),
    "fused_mlp_bwd_f32_n16": ("animnerf_tpu_torch/csrc/mlp_f32.cu",
                              "animnerf_tpu/ops/fused_mlp.py:227"),
    # kernels 8, 9, 2 and 5 above 16 neighbours: K = 24 and 40 (kernels 8
    # and 9 on their warp-per-point kernels, kernel 2 on its K = 32
    # instantiation and its run-time-k version)
    **{f"{name}_k{k}": (src, replaces) for k in (24, 40)
       for name, src, replaces in (
           ("knn_packed", "animnerf_tpu_torch/csrc/knn_packed.cu",
            "animnerf_tpu/ops/knn_pallas.py:161"),
           ("knn_exact", "animnerf_tpu_torch/csrc/knn_exact.cu",
            "animnerf_tpu/ops/knn_pallas.py:35"),
           ("warp_blend", "animnerf_tpu_torch/csrc/warp_blend.cu",
            "animnerf_tpu/ops/warp_blend.py:48"),
           ("scatter", "animnerf_tpu_torch/csrc/scatter.cu",
            "animnerf_tpu/ops/blend.py:59"))},
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


# ---------------------------------------------------------------- trace

# trace_syncs: the tracer (``utils/trace.py``) on the card. Spans timed a
# path for the host cost of one span, off and on
TRACE_SPAN_REPS = 20000
TRACE_SPANS_A_CALL = 40
# rounds of off / recording / profiled calls for a path's on-cost
TRACE_COST_ROUNDS = 8
# the exported trace's ranges against the tracer's stamps, us
TRACE_CLOCK_US = 100.0


def sync_check(fn) -> dict:
    """``fn`` (one root call) once under ``torch.cuda``'s sync debug mode
    ("warn") with the tracer recording: every synchronising call with
    the tracer's open spans at it. One the autograd engine meets in a
    backward is reported when ``backward`` returns (the innermost open
    span then ``train.backward``), so those are held against the number
    of wait spans the backward opened. Returns the counts, the wait spans
    by name and the calls outside every wait span (where)."""
    import warnings

    import torch

    from animnerf_tpu_torch.utils import trace

    hits, active = [], []

    def hook(message, category, filename, lineno, file=None, line=None):
        if active and "synchroniz" in str(message):
            hits.append((trace.open_spans(),
                         f"{os.path.relpath(filename, ROOT)}:{lineno}"))

    torch.cuda.synchronize()
    trace.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        with trace.recording():
            torch.cuda.set_sync_debug_mode("warn")
            active.append(True)
            try:
                fn()
            finally:
                active.clear()
                torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    (call,) = trace.calls()
    spans = call["spans"]

    def under(s, name) -> bool:
        p = s["parent"]
        while p >= 0:
            if spans[p]["name"] == name:
                return True
            p = spans[p]["parent"]
        return False

    waits = [s for s in spans if s["wait"]]
    in_wait = [h for h in hits if any(n.startswith("wait.") for n in h[0])]
    deferred = [h for h in hits if h not in in_wait and h[0]
                and h[0][-1] == "train.backward"]
    outside = [h for h in hits if h not in in_wait and h not in deferred]
    bwd_waits = sum(under(s, "train.backward") for s in waits)
    by_name = {}
    for s in waits:
        by_name[s["name"]] = by_name.get(s["name"], 0) + 1
    return {"root": call["root"], "syncs": len(hits),
            "syncs_in_waits": len(in_wait),
            "backward_syncs": len(deferred), "backward_waits": bwd_waits,
            "wait_spans": len(waits), "waits_by_name": by_name,
            "wait_ms": sum(s["t1"] - s["t0"] for s in waits) * 1e-6,
            "outside": sorted({f"{w} in {'/'.join(o) or '-'}"
                               for o, w in outside}),
            "counters": call["counters"], "launches": call["launches"]}


def clock_session(fn) -> dict:
    """``fn`` twice under ``torch.profiler`` (CPU and CUDA): the gap, us,
    between each span of the second call and its ``user_annotation``
    range in the exported trace, counted from ``baseTimeNanoseconds``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from animnerf_tpu_torch.utils import trace

    trace.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            d = json.load(f)
    finally:
        os.remove(path)
    base = d["baseTimeNanoseconds"]
    events = {}
    for e in d["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            events.setdefault(e["name"], []).append(e)
    calls = trace.calls()
    by_name = {}
    for c in calls:
        for s in c["spans"]:
            by_name.setdefault(s["name"], []).append((c["id"], s))
    gaps, missing = [], []
    for name, spans in by_name.items():
        evs = sorted(events.get(name, []), key=lambda e: e["ts"])
        if len(evs) != len(spans):
            missing.append([name, len(spans), len(evs)])
            continue
        for (cid, s), e in zip(sorted(spans, key=lambda x: x[1]["t0"]), evs):
            if cid == calls[-1]["id"]:
                gaps.append((max(
                    abs(float(e["ts"]) - (s["t0"] - base) / 1e3),
                    abs(float(e["ts"]) + float(e["dur"])
                        - (s["t1"] - base) / 1e3)), name))
    gaps.sort()
    return {"spans": len(gaps), "median_us": gaps[len(gaps) // 2][0],
            "max_us": gaps[-1][0], "worst": gaps[-1][1],
            "unmatched": missing}


def clock_check(fn, tries: int = 3) -> dict:
    """clock_session until every span lies within TRACE_CLOCK_US, at
    most ``tries`` times (a host that preempts the process between the
    profiler's stamp and the tracer's can push one span past it, as the
    CPU test allows): each session's reading and the best."""
    sessions = []
    for _ in range(tries):
        sessions.append(clock_session(fn))
        if sessions[-1]["max_us"] < TRACE_CLOCK_US:
            break
    best = min(sessions, key=lambda r: r["max_us"])
    return dict(best, sessions=[[r["max_us"], r["worst"]]
                                for r in sessions])


def span_cost_ns() -> dict:
    """Host ns per ``with trace.span(...)``, TRACE_SPAN_REPS of them in
    root calls of TRACE_SPANS_A_CALL (a step's or a view's size): off,
    recording without a profiler, and under a CUDA-only profiler (the
    benchmark's device pass); the bare loop beside them."""
    import contextlib as cl

    from torch.profiler import ProfilerActivity, profile

    from animnerf_tpu_torch.utils import trace

    def loop(make, root) -> float:
        t = time.perf_counter_ns()
        for _ in range(TRACE_SPAN_REPS // TRACE_SPANS_A_CALL):
            with root("cost", root=True):
                for _ in range(TRACE_SPANS_A_CALL - 1):
                    with make("x"):
                        pass
        return (time.perf_counter_ns() - t) / TRACE_SPAN_REPS

    def bare(name, root=False):
        return cl.nullcontext()

    out = {"bare_loop": loop(bare, bare),
           "off": loop(trace.span, trace.span)}
    with trace.recording():
        out["recording"] = loop(trace.span, trace.span)
    with profile(activities=[ProfilerActivity.CUDA]):
        out["cuda_profiler"] = loop(trace.span, trace.span)
    trace.clear()
    return out


def span_table(call: dict) -> dict:
    """{span name: [spans, host ms, self ms]} of one call record (self:
    less the time of its child spans)."""
    spans = call["spans"]
    child = [0] * len(spans)
    for s in spans:
        if s["parent"] >= 0:
            child[s["parent"]] += s["t1"] - s["t0"]
    out = {}
    for s, c in zip(spans, child):
        row = out.setdefault(s["name"], [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (s["t1"] - s["t0"]) * 1e-6
        row[2] += (s["t1"] - s["t0"] - c) * 1e-6
    return {k: [n, round(a, 3), round(b, 3)] for k, (n, a, b) in out.items()}


def on_cost(fn, rounds: int = TRACE_COST_ROUNDS) -> dict:
    """Host ms a call of ``fn`` (synchronised) with the tracer off,
    recording, and under a CUDA-only profiler (the benchmark's device
    pass) with the spans on and with every span, wait and counter
    replaced by the off path (the program before the tracer), in turns
    over ``rounds``; the medians, and the span table of the last
    recorded call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from animnerf_tpu_torch.utils import trace

    def timed() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    def off(*args, **kwargs):
        return trace._OFF

    ms = {"off": [], "recording": [], "cuda_profiler": [],
          "cuda_profiler_no_spans": []}
    table = None
    for _ in range(rounds):
        ms["off"].append(timed())
        with trace.recording():
            ms["recording"].append(timed())
        table = span_table(trace.calls()[-1])
        with profile(activities=[ProfilerActivity.CUDA]):
            ms["cuda_profiler"].append(timed())
        saved = {k: getattr(trace, k) for k in ("span", "wait", "count",
                                                  "wait_in_backward")}
        for k in saved:
            setattr(trace, k, off)
        try:
            with profile(activities=[ProfilerActivity.CUDA]):
                ms["cuda_profiler_no_spans"].append(timed())
        finally:
            for k, v in saved.items():
                setattr(trace, k, v)
    trace.clear()
    return {"median_ms": {k: float(np.median(v)) for k, v in ms.items()},
            "spans": table}


def trace_phase() -> dict:
    """The tracer on the card: one SMPL training step (bench.py's
    16 x 1024 rays) and one 512^2 compacted scale512 view under the sync
    debug mode, no synchronising call outside a wait span (the backward's
    as many as its wait spans); each path's spans against the profiler
    trace's clock; each path's host ms a call with the tracer off,
    recording and under a CUDA-only profiler, and its spans' times; the
    host cost of a span."""
    import torch

    from animnerf_tpu_torch.render.inference import (
        Renderer,
        turntable_rotation,
    )
    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.training.system import RowsCompactTrainer

    system = AnimNeRFSystem(FLAGSHIP_CFG, smpl_rig(), device="cuda", seed=0)
    trainer = RowsCompactTrainer(system, steps_per_epoch=100)
    batches = train_batches(16, 1024, range(2), "cuda")
    trainer.step(batches[0])
    step = sync_check(lambda: trainer.step(batches[1]))
    step_clock = clock_check(lambda: trainer.step(batches[1]))
    step_cost = on_cost(lambda: trainer.step(batches[1]))
    del trainer, system, batches
    torch.cuda.empty_cache()

    ck, vsystem, bp, tmpl, _ = scale512("cuda")
    renderer = Renderer(vsystem, prepass="boxes")
    rays = frame_rays(512, 512)
    P = turntable_rotation(29, 64)

    def view():
        return renderer.render_frame(bp, tmpl, rays, P, (512, 512))

    view()
    frame = sync_check(view)
    frame_clock = clock_check(view)
    frame_cost = on_cost(view)
    for name, r in (("step", step), ("view", frame)):
        check(not r["outside"], f"trace: synchronising calls of the {name} "
              f"outside every wait span: {r['outside']}")
        check(r["backward_syncs"] == r["backward_waits"],
              f"trace: the {name}'s backward synchronised "
              f"{r['backward_syncs']} times in {r['backward_waits']} waits")
    for name, r in (("step", step_clock), ("view", frame_clock)):
        check(not r["unmatched"] and r["max_us"] < TRACE_CLOCK_US,
              f"trace: the {name}'s spans off the profiler's clock: {r}")
    return {"step": step, "step_clock": step_clock, "step_cost": step_cost,
            "view": frame, "view_clock": frame_clock,
            "view_cost": frame_cost, "span_ns": span_cost_ns()}


# ---------------------------------------------------------------- fit

# the fit phase's dataset: the port's writer at full width (512^2 frames,
# the V=6890 / J=24 rig), frames 1-8 train, 9-10 val, 11-12 test
FIT_FRAMES = 12
FIT_STEPS = 60


def fit_config(root: str, opts=None):
    """The flagship field (64 + 32 samples, freqs_xyz 10, bf16) on the fit
    dataset: 16 frames x 32^2 foreground_pixel rays a step, FIT_STEPS
    steps, every step logged (``opts``: in place of ``fit_opts(root)``)."""
    from animnerf_tpu_torch.config import finalize, get_default_config

    cfg = get_default_config()
    cfg.merge_from_list(fit_opts(root) if opts is None else opts)
    return finalize(cfg)


def fit_opts(root: str) -> list:
    """fit_config's options, as the train CLI takes them."""
    return [
        "root_dir", root, "model_path", os.path.join(root, "models"),
        "gender", "neutral", "pose_dim", "69", "img_wh", "(512, 512)",
        "n_samples", "64", "n_importance", "32", "freqs_xyz", "10",
        "compute_dtype", "bfloat16", "exp_name", "fit",
        "checkpoints_dir", os.path.join(root, "ck"),
        "logs_dir", os.path.join(root, "logs"),
        "train.frame_start_ID", "1", "train.frame_end_ID", "8",
        "train.frame_skip", "1", "train.batch_size", "16",
        "train.subsamplesize", "32", "train.subsampletype",
        "foreground_pixel", "train.max_steps", str(FIT_STEPS),
        "train.log_every", "1",
        "val.frame_start_ID", "9", "val.frame_end_ID", "10",
        "val.frame_skip", "1",
        "test.frame_start_ID", "11", "test.frame_end_ID", "12",
        "test.frame_skip", "1"]


def fit_phase(root: str, train_median_ms: float,
              train_compact: float) -> dict:
    """Training from a dataset on disk, as ``python -m
    animnerf_tpu_torch.cli.train`` runs it: the port writes a synthetic
    dataset at full width into ``root``, ``fit`` takes FIT_STEPS steps
    (launch counts reset just before and read just after: kernels 1-6
    must launch) and renders one validation frame, ``evaluate`` scores
    the test frames from ``last``, and ``last`` loaded into a fresh system
    must give the trained parameters bit for bit. Host-clock medians of
    the step, the loop's wait on the loader and the producer's batch,
    beside the train phase's step median (synthetic batches in memory);
    the coarse survivors a step of each. The dataset and ``last`` stay
    for the cli phase."""
    import torch

    from animnerf_tpu_torch.data.synthetic import write_synthetic_dataset
    from animnerf_tpu_torch.models.body_params import (
        load_body_params_from_dataset,
    )
    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.training import loop as TL
    from animnerf_tpu_torch.training.checkpoints import load_params

    t0 = time.perf_counter()
    write_synthetic_dataset(root, num_frames=FIT_FRAMES,
                            img_wh=(512, 512), num_verts=6890,
                            num_joints=24, seed=0)
    write_s = time.perf_counter() - t0
    cfg = fit_config(root)
    stats: dict = {}
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    ckpt_dir = TL.fit(cfg, device="cuda", stats=stats)
    fit_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check(all(launches[k] > 0 for k in TRAIN_KERNELS),
          f"a kernel of the fit path was never launched: {launches}")
    losses = [loss for _, loss in stats["losses"]]
    check(len(losses) == FIT_STEPS and all(map(math.isfinite, losses)),
          f"fit losses: {losses}")

    # the trained parameters against 'last' in a fresh system
    trained = {k: v.detach().clone() for k, v in
               stats["system"].named_parameters()}
    del stats["system"]
    last = os.path.join(ckpt_dir, "last")
    fresh = TL.build_system(cfg, "cuda")
    fresh.set_body_params(load_body_params_from_dataset(
        cfg.frame_IDs, cfg.root_dir, cfg.model_type))
    load_params(last, fresh)
    got = dict(fresh.named_parameters())
    same = sorted(got) == sorted(trained) and all(
        torch.equal(got[k], v) for k, v in trained.items())
    check(same, "last reloaded differs from the trained parameters")
    del fresh, got, trained

    estats: dict = {}
    t0 = time.perf_counter()
    scores = TL.evaluate(cfg, last, device="cuda", stats=estats)
    eval_s = time.perf_counter() - t0
    check(all(map(math.isfinite, scores.values())), f"test: {scores}")
    step_ms = float(np.median(stats["step_s"])) * 1e3
    rays = cfg.train.batch_size * cfg.train.subsamplesize ** 2
    return {
        "dataset": f"{FIT_FRAMES} frames 512x512, V=6890 J=24, "
                   "the port's writer", "write_s": write_s,
        "steps": len(stats["step_s"]), "rays_per_step": rays,
        "median_step_ms": step_ms,
        "rays_per_s": rays / (step_ms / 1e3),
        "median_compact_count": float(np.median(
            stats["compact_count"])),
        "train_phase_median_step_ms": train_median_ms,
        "train_phase_median_compact_count": train_compact,
        "median_loader_wait_ms": float(np.median(stats["wait_s"])) * 1e3,
        "max_loader_wait_ms": float(np.max(stats["wait_s"])) * 1e3,
        "median_produce_ms": float(np.median(stats["produce_s"])) * 1e3,
        "val_frame_ms": [t * 1e3 for t in stats["val_s"]],
        "eval_frame_ms": [t * 1e3 for t in estats["frame_s"]],
        "eval_score_ms": [t * 1e3 for t in estats["score_s"]],
        "save_ms": [t * 1e3 for t in stats["save_s"]],
        "losses_first5": losses[:5], "losses_last5": losses[-5:],
        "test_psnr": scores["psnr"], "test_ssim": scores["ssim"],
        "last_reload_bit_equal": same, "launches": launches,
        "fit_s": fit_s, "evaluate_s": eval_s, "last": last}


# ------------------------------------------------------------------ cli

# the post-training CLIs on the fit phase's dataset and 'last': views and
# mocap frames at the dataset's 512x512, meshes at the mesh CLI's default
# grid and ranges, the card-vs-CPU sigma grid at 48^3
CLI_VIEWS = 8
CLI_POSES = 8
MESH_N = 256
MESH_RANGES = ([-1.2, 1.2], [-1.2, 1.2], [-1.2, 1.2])
MESH_THRESHOLD = 20.0
MESH_VIEWS = 4
# the scale512 checkpoint's densities peak near 13 (6 epochs of a demo
# budget), below the CLI's default threshold of 20: its mesh is cut at 3,
# as tools/mesh_demo.py cut the mesh that mesh_stats.json counts
SCALE512_THRESHOLD = 3.0
PARITY_N = 48
# card vs CPU bounds of the relu(sigma) grid, as a share of 1 + max |sigma|
SIGMA_BOUNDS = {"float32": 1e-3, "bfloat16": 5e-2}
MESH_STATS = os.path.join(ROOT, "docs", "demo", "scale512",
                          "mesh_stats.json")
MESH_KERNELS = ("knn", "warp_blend", "fused_mlp")
_TETS = ((0, 5, 1, 6), (0, 1, 3, 6), (0, 3, 2, 6),
         (0, 2, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6))


def marching_model(field, iso: float = 0.0):
    """A numpy model of ``native/marching_tets.cpp``: the soup of
    ``marching_tets_numpy`` (each corner of a triangle emitted on its
    tetrahedron edge, the same formula and direction), each emission
    tagged with its edge and its place in the C++ loop (cell, tetrahedron,
    call), then merged as the C++ merges: an edge's vertex is its first
    emission's, vertex ids in order of first emission. Returns (soup
    triangles (T, 3, 3) in loop order, merged vertices, merged triangles)."""
    f = np.asarray(field, np.float32)
    nx, ny, nz = f.shape
    ii, jj, kk = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    base = np.stack([ii, jj, kk], -1).reshape(-1, 3)
    bits = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)])
    corner = base[:, None, :] + bits[None]               # (C, 8, 3)
    vals = f[corner[..., 0], corner[..., 1], corner[..., 2]]
    lin = (corner[..., 0] * ny + corner[..., 1]) * nz + corner[..., 2]
    # per case: (edges as (from, to) of (inside order, outside order)
    # roles, triangles as call indices); roles: ("i", n) the n-th inside
    # corner, ("o", n) the n-th outside corner, in tetrahedron order
    cases = {1: ([(("i", 0), ("o", 0)), (("i", 0), ("o", 1)),
                  (("i", 0), ("o", 2))], [(0, 1, 2)]),
             3: ([(("o", 0), ("i", 0)), (("o", 0), ("i", 1)),
                  (("o", 0), ("i", 2))], [(0, 2, 1)]),
             2: ([(("i", 0), ("o", 0)), (("i", 0), ("o", 1)),
                  (("i", 1), ("o", 1)), (("i", 1), ("o", 0))],
                 [(0, 1, 2), (0, 2, 3)])}
    keys, pos, order, tris, tri_order = [], [], [], [], []
    n_em = 0
    for ti, tet in enumerate(_TETS):
        v = vals[:, tet]
        inside = v < iso
        ni = inside.sum(1)
        role = {"i": np.argsort(~inside, axis=1, kind="stable"),
                "o": np.argsort(inside, axis=1, kind="stable")}
        for count, (edges, tri_calls) in cases.items():
            cells = np.flatnonzero(ni == count)
            if not len(cells):
                continue
            ids = []
            for slot, ((ra, na), (rb, nb)) in enumerate(edges):
                a = np.asarray(tet)[role[ra][cells, na]]
                b = np.asarray(tet)[role[rb][cells, nb]]
                pa, pb = corner[cells, a], corner[cells, b]
                va, vb = vals[cells, a], vals[cells, b]
                denom = vb - va
                t = np.where(denom != 0,
                             (iso - va) / np.where(denom == 0, 1, denom), 0.5)
                t = np.clip(t, 0, 1)[:, None]
                pos.append((pa + t * (pb - pa)).astype(np.float32))
                la, lb = lin[cells, a], lin[cells, b]
                keys.append(np.minimum(la, lb) * (nx * ny * nz)
                            + np.maximum(la, lb))
                order.append((cells * 6 + ti) * 4 + slot)
                ids.append(n_em + np.arange(len(cells)))
                n_em += len(cells)
            for k, (x, y, z) in enumerate(tri_calls):
                tris.append(np.stack([ids[x], ids[y], ids[z]], 1))
                tri_order.append((cells * 6 + ti) * 2 + k)
    if not tris:
        return (np.zeros((0, 3, 3), np.float32), np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.int32))
    keys, pos, order = (np.concatenate(x) for x in (keys, pos, order))
    tris = np.concatenate(tris)[np.argsort(np.concatenate(tri_order),
                                           kind="stable")]
    soup = pos[tris]
    # merge: emissions in loop order, the first of each edge keeps its
    # position and takes the next id
    by_order = np.argsort(order, kind="stable")
    _, first = np.unique(keys[by_order], return_index=True)
    firsts = np.sort(first)                      # ranks in loop order
    edge_of = np.unique(keys, return_inverse=True)[1]
    vid_of_edge = np.empty(len(firsts), np.int64)
    vid_of_edge[edge_of[by_order[firsts]]] = np.arange(len(firsts))
    verts = pos[by_order[firsts]]
    return soup, verts, vid_of_edge[edge_of][tris].astype(np.int32)


def sorted_triangles(soup):
    """(T, 3, 3) triangles -> (T, 9) rows in lexicographic order."""
    flat = np.asarray(soup, np.float32).reshape(len(soup), 9)
    return flat[np.lexsort(flat.T[::-1])]


def marching_check(field) -> dict:
    """The native marching (``marching_cubes``) against
    ``marching_tets_numpy`` through ``marching_model``: the model's soup
    sorted is bit-equal to marching_tets_numpy's sorted, and the model's
    merge is bit-equal to the native vertices and triangles. (The native
    and numpy soups themselves differ where two tetrahedra meet an edge
    from opposite ends: the native keeps the first emission's rounding.)"""
    from animnerf_tpu_torch.ops.marching import (
        marching_cubes,
        marching_tets_numpy,
    )

    t0 = time.perf_counter()
    nv, nt = marching_cubes(field, 0.0)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pv, pt = marching_tets_numpy(field, 0.0)
    numpy_s = time.perf_counter() - t0
    soup, mv, mt = marching_model(field, 0.0)
    soup_equal = bool(np.array_equal(sorted_triangles(soup),
                                     sorted_triangles(pv[pt])))
    merge_equal = bool(np.array_equal(mv, nv) and np.array_equal(mt, nt))
    raw_equal = bool(np.array_equal(sorted_triangles(nv[nt]),
                                    sorted_triangles(pv[pt])))
    check(len(nt) > 0 and soup_equal and merge_equal,
          f"marching: {len(nt)} triangles, soup {soup_equal}, "
          f"merge {merge_equal}")
    return {"triangles": int(len(nt)), "native_vertices": int(len(nv)),
            "numpy_vertices": int(len(pv)), "soup_bit_equal": soup_equal,
            "merge_bit_equal": merge_equal,
            "native_vs_numpy_sorted_bit_equal": raw_equal,
            "native_ms": native_s * 1e3, "numpy_ms": numpy_s * 1e3}


def _mocap(root: str, frames: int, seed: int = 0) -> str:
    """A seeded Mixamo-layout ``<root>/mocap/0007/result.pkl``."""
    import pickle

    actions = os.path.join(root, "mocap")
    os.makedirs(os.path.join(actions, "0007"), exist_ok=True)
    rng = np.random.default_rng(seed)
    with open(os.path.join(actions, "0007", "result.pkl"), "wb") as f:
        pickle.dump({
            "anim_len": frames,
            "smpl_array": rng.normal(scale=0.1, size=(frames, 72)).astype(
                np.float32),
            "cam_array": rng.normal(scale=0.1, size=(frames, 4)).astype(
                np.float32)}, f)
    return actions


def _body_px(path: str) -> int:
    """Pixels of a PNG on the white background that are not white."""
    from animnerf_tpu_torch.utils.image import read_png

    return int((read_png(path)[..., :3] < 250).any(-1).sum())


def _gif_ok(path: str) -> bool:
    with open(path, "rb") as f:
        data = f.read()
    return data[:6] == b"GIF89a" and data[-1:] == b"\x3b"


def cli_phase(root: str, last: str) -> dict:
    """The post-training CLIs on the fit phase's dataset and ``last``,
    each through its ``main`` on the card with the launch counts reset
    just before and read just after: novel views (CLI_VIEWS at 512x512,
    then with ``--betas_2th 0.5``, then one ``--template`` view; kernels
    1-4 launched), novel poses (a seeded CLI_POSES-frame mocap), the mesh
    CLI at MESH_N^3 with ``--vis`` (kernels 1-3); then the mesh CLI's
    query again with the far skip off and on (bit-equal)."""
    import torch

    from animnerf_tpu_torch.cli import common, extract_mesh
    from animnerf_tpu_torch.cli import novel_pose, novel_view
    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.render.inference import Renderer
    from animnerf_tpu_torch.utils.image import read_png

    opts = ["outputs_dir", os.path.join(root, "out")]
    total = {k: 0 for k in _build.LAUNCHES}
    out: dict = {}

    def run(main, args, need=(), absent=()):
        stats: dict = {}
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        save_dir = main(["--ckpt_path", last, *args, *opts], stats=stats)
        seconds = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        check(all(launches[k] > 0 for k in need)
              and all(launches[k] == 0 for k in absent),
              f"{main.__module__} {args}: launches {launches}")
        return save_dir, stats, launches, seconds

    # ---- novel views: plain, shape-edited, T-pose
    views, first = {}, {}
    for tag, args in (("plain", ["--n_views", str(CLI_VIEWS)]),
                      ("betas_2th", ["--n_views", str(CLI_VIEWS),
                                     "--betas_2th", "0.5"]),
                      ("template", ["--n_views", "1", "--template"])):
        d, st, launches, sec = run(novel_view.main, args,
                                   need=SERVE_KERNELS)
        n = len(st["view_s"])
        imgs = sorted(os.listdir(os.path.join(d, "images")))
        body = _body_px(os.path.join(d, "images", imgs[0]))
        check(len(imgs) == n and body > 500
              and _gif_ok(os.path.join(d, "novel_view.gif")),
              f"novel_view {tag}: {len(imgs)} images, {body} body px")
        views[tag] = {
            "views": n, "view_ms": [t * 1e3 for t in st["view_s"]],
            "median_view_ms": float(np.median(st["view_s"])) * 1e3,
            "gif_ms_per_frame": st["gif_s"] / n * 1e3,
            "body_px_view0": body, "launches": launches,
            "launches_per_view": {k: v / n for k, v in launches.items()
                                  if v}, "seconds": sec}
        first[tag] = read_png(os.path.join(d, "images", imgs[0]))
    # reported, not checked: the seeded rig's shape directions are small
    views["betas_2th"]["changed_px_view0"] = int(
        (first["plain"] != first["betas_2th"]).any(-1).sum())
    out["novel_view"] = views

    # ---- novel poses from a seeded mocap
    actions = _mocap(root, CLI_POSES)
    d, st, launches, sec = run(novel_pose.main, [
        "--actions_dir", actions, "--action_type", "0007",
        "--frame_skip", "1"], need=SERVE_KERNELS)
    n = len(st["render_s"])
    overlay = _body_px(os.path.join(d, "smpls_vis", "000000.png"))
    check(n == CLI_POSES and overlay > 500
          and _gif_ok(os.path.join(d, "novel_pose.gif")),
          f"novel_pose: {n} frames, overlay {overlay} px")
    out["novel_pose"] = {
        "frames": n, **{f"median_{k[:-2]}_ms": float(np.median(v)) * 1e3
                        for k, v in st.items()},
        "overlay_px_frame0": overlay, "launches": launches,
        "launches_per_frame": {k: v / n for k, v in launches.items() if v},
        "seconds": sec}

    # ---- the mesh CLI at the default grid, with --vis
    d, st, launches, sec = run(extract_mesh.main, [
        "--N_grid", str(MESH_N), "--sigma_threshold", str(MESH_THRESHOLD),
        "--vis", "--n_views", str(MESH_VIEWS)], need=MESH_KERNELS,
        absent=("permute_lanes",))
    check(os.path.isfile(os.path.join(d, "mesh.obj"))
          and os.path.isfile(os.path.join(d, "smpl.obj"))
          and _gif_ok(os.path.join(d, "3d_rec.gif")), "extract_mesh outputs")
    out["extract_mesh"] = mesh_line(st, launches)
    out["extract_mesh"]["seconds"] = sec

    # ---- the same query, the far skip off and on
    cfg = common.resolve_cfg(last, None, opts)
    system = common.load_system_and_params(cfg, last, "cuda")
    fidx, bp, tmpl = common.load_frame_params(cfg, 1, "cuda")
    bp = common.optimized_frame_params(cfg, system, fidx, bp)
    renderer = Renderer(system)
    points = extract_mesh.mesh_grid(renderer, bp, tmpl, MESH_N,
                                    MESH_RANGES)[0]
    grids, query_ms = {}, {}
    for on in (False, True):
        set_far_skip(system, on)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        grids[on] = renderer.query_sigma_observed(bp, tmpl, points)
        query_ms[on] = (time.perf_counter() - t0) * 1e3
        if on:
            share = far_share()
            far_launches = dict(_build.LAUNCHES)
    check(np.array_equal(grids[False], grids[True]),
          "the far skip changed the sigma grid")
    out["far_skip_query"] = {
        "points": int(points.shape[1]), "query_ms_off": query_ms[False],
        "query_ms_on": query_ms[True], "bit_equal_off_on": True,
        **share, "launches_on": far_launches}
    out["cli_launches"] = total
    return out


def mesh_line(st: dict, launches: dict) -> dict:
    """The mesh stages' host-clock ms from ``extract_mesh``'s stats."""
    q = st["query_s"]
    line = {"grid": MESH_N, "vertices": int(st["n_verts"]),
            "faces": int(st["n_faces"]),
            "grid_ms": st["grid_s"] * 1e3, "query_ms": q * 1e3,
            "query_points_per_s": MESH_N**3 / q,
            "smooth_ms": st["smooth_s"] * 1e3,
            "march_ms": st["march_s"] * 1e3,
            "save_obj_ms": st["save_s"] * 1e3, "launches": launches,
            "launches_per_mesh": {k: v for k, v in launches.items() if v}}
    if "raster_s" in st:
        line["raster_ms"] = [t * 1e3 for t in st["raster_s"]]
    return line


def mesh_scale512(root: str):
    """``extract_mesh`` at MESH_N^3 on the trained scale512 system (the
    way phase 4 builds it) in its optimised frame-1 pose (the
    checkpoint's body params, as the mesh CLI takes them), cut at
    SCALE512_THRESHOLD; its OBJ written and MESH_VIEWS raster views
    timed; the vertex and face counts beside ``docs/demo/scale512/
    mesh_stats.json``'s (an older JAX tool's count: printed, not
    checked). Returns (the line, (system, frame params, template
    params))."""
    import torch

    from animnerf_tpu_torch.cli.extract_mesh import extract_mesh
    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.render.inference import Renderer
    from animnerf_tpu_torch.utils.io import save_obj
    from animnerf_tpu_torch.utils.renderer import SoftwareRenderer

    ck, system, _, tmpl, _ = scale512("cuda")
    bp = {k: v[:1] for k, v in ck["body_params"].items()}
    renderer = Renderer(system)
    st: dict = {}
    torch.cuda.synchronize()
    reset_counts()
    v, f, _, sig = extract_mesh(renderer, bp, tmpl, MESH_N, MESH_RANGES,
                                SCALE512_THRESHOLD, True, st)
    launches = dict(_build.LAUNCHES)
    check(all(launches[k] > 0 for k in MESH_KERNELS) and len(f) > 0,
          f"scale512 mesh: {len(f)} faces, launches {launches}")
    t0 = time.perf_counter()
    save_obj(os.path.join(root, "scale512_mesh.obj"), v, f)
    st.update(save_s=time.perf_counter() - t0, n_verts=len(v),
              n_faces=len(f))
    raster = SoftwareRenderer((512, 512))
    raster.set_camera(1.2 * 512, 1.2 * 512, 256, 256, np.eye(3),
                      np.array([0.0, 0.0, 3.0]))
    st["raster_s"] = []
    for i in range(MESH_VIEWS):
        t0 = time.perf_counter()
        img = raster.render(v, f, angle=-i / MESH_VIEWS * 360,
                            axis=[0, 1, 0])
        st["raster_s"].append(time.perf_counter() - t0)
    line = mesh_line(st, launches)
    with open(MESH_STATS) as fh:
        ref = json.load(fh)
    line.update(
        sigma_threshold=SCALE512_THRESHOLD, sigma_max=float(sig.max()),
        inside_share=float((sig > SCALE512_THRESHOLD).mean()),
        obj_bytes=os.path.getsize(os.path.join(root, "scale512_mesh.obj")),
        raster_body_px=int((img < 250).any(-1).sum()),
        mesh_stats_json=ref,
        vertices_vs_json=len(v) / ref["vertices"] - 1.0,
        faces_vs_json=len(f) / ref["faces"] - 1.0)
    return line, (system, bp, tmpl)


def cli_parity(system, bp, tmpl) -> dict:
    """``query_sigma_observed`` on a PARITY_N^3 grid of the mesh ranges
    about the scale512 body, on the card (kernels) and the CPU (plain
    versions), in f32 and bf16, within SIGMA_BOUNDS x (1 + max |sigma|);
    then the marching of the card's f32 field (threshold, smooth, negate,
    as the mesh CLI) against marching_tets_numpy (``marching_check``)."""
    from animnerf_tpu_torch.cli.extract_mesh import mesh_grid
    from animnerf_tpu_torch.ops.marching import smooth
    from animnerf_tpu_torch.render.inference import Renderer
    from animnerf_tpu_torch.utils.convert import load_checkpoint

    ck = load_checkpoint(CKPT)
    points = mesh_grid(Renderer(system), bp, tmpl, PARITY_N, MESH_RANGES)[0]
    out, fields = {}, {}
    for dtype, bound in SIGMA_BOUNDS.items():
        sig = {}
        for dev in ("cuda", "cpu"):
            s = scale512_system(ck, dev, compute_dtype=dtype)
            t0 = time.perf_counter()
            sig[dev] = Renderer(s, device=dev).query_sigma_observed(
                bp, tmpl, points)
            sig[dev + "_ms"] = (time.perf_counter() - t0) * 1e3
        err = float(np.abs(sig["cuda"] - sig["cpu"]).max())
        top = float(np.abs(sig["cpu"]).max())
        check(err <= bound * (1 + top) and top > SCALE512_THRESHOLD,
              f"{dtype} sigma grid: max |d| {err} for bound {bound} x "
              f"(1 + {top})")
        out[dtype] = {"max_abs_err": err, "max_sigma": top, "bound":
                      bound * (1 + top), "card_ms": sig["cuda_ms"],
                      "cpu_ms": sig["cpu_ms"],
                      "inside_share": float((sig["cuda"] >
                                             SCALE512_THRESHOLD).mean())}
        fields[dtype] = sig["cuda"]
    sig = np.maximum(fields["float32"].reshape((PARITY_N,) * 3), 0)
    out["marching"] = marching_check(-smooth(sig - SCALE512_THRESHOLD))
    out["points"] = int(points.shape[1])
    return out


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


def profile_call(fn, what: str, by_kernel: bool = False):
    """Device time by kernel over one more call of fn (torch.profiler);
    the launch counts of the main path were read before this.
    ``by_kernel``: every device event's ms and count by name too."""
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
              if any(k in e.key for k in FWD_NAMES)) / 1e3
    knn = sum(e.self_device_time_total for e in events
              if any(k in e.key for k in KNN_KERNEL_NAMES)) / 1e3
    exact = [e for e in events if "knn_exact" in e.key
             and "knn_exact_rows" not in e.key]
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
                    for e in events[:15]],
            **({"by_kernel": by_name(events)} if by_kernel else {})}


def by_name(events) -> dict:
    """{kernel_name: [device ms, launches]} over profiler events, summed
    where two events share a name."""
    out = {}
    for e in events:
        v = out.setdefault(kernel_name(e.key), [0.0, 0])
        v[0] += e.self_device_time_total / 1e3
        v[1] += e.count
    return out


# the MLP backward's kernels other than its main kernel: the bf16 weight-
# gradient pass (mlp_wgrad_prep, mlp_wgrad_bf16), the split reduction and
# the f32 path's weight-gradient kernel (mlp_wgrad_f32; the first SIMT
# version's wgrad_f32, wgrad_heads_f32 and bias_sums_f32, which
# tools/ab_mlp_f32.py profiles in older checkouts)
BWD_REST_NAMES = ("mlp_wgrad", "reduce_splits", "wgrad_f32", "wgrad_heads",
                  "bias_sums")
# kernel 3 by profiler name: bf16, f32 (the first SIMT version's
# fused_mlp_f32_kernel in older checkouts)
FWD_NAMES = ("mlp_fwd_bf16", "mlp_fwd_f32", "fused_mlp_f32_kernel")


def bwd_split(events) -> dict:
    """Device ms and launches of the MLP backward's main kernel and of its
    other kernels (BWD_REST_NAMES) among profiler events, and of each of
    them by name ({name: [ms, launches]})."""
    main = [e for e in events if "mlp_bwd_main" in e.key]
    rest = [e for e in events if any(k in e.key for k in BWD_REST_NAMES)]
    return {"main_ms": sum(e.self_device_time_total for e in main) / 1e3,
            "wgrad_ms": sum(e.self_device_time_total for e in rest) / 1e3,
            "main_launches": sum(e.count for e in main),
            "rest_launches": sum(e.count for e in rest),
            "by_kernel": by_name(main + rest)}


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


# f32_profile: the flagship field with compute_dtype float32 (kernels 3
# and 6 in f32), timed steps and views
F32_STEPS = 5
F32_VIEW = 29
F32_VIEWS = 3


def f32_profile(dev) -> dict:
    """compute_dtype float32 with the flagship field. The step: bench.py's
    16 x 1024 rays on the seed-0 rig (``RowsCompactTrainer.step``), a
    warm-up then F32_STEPS distinct batches. The view: the scale512
    checkpoint on the seed-3 rig, view F32_VIEW at 512x512 through
    ``Renderer.render_stream``, a warm-up then F32_VIEWS times. For each:
    the host-clock median (each synchronised), the launch counts (set to 0
    just before, read just after; kernels 3 and 6 must launch in the step,
    kernel 3 in the view), the peak allocated memory over the timed calls,
    and one profiled call (device-busy ms by kernel name, idle share)."""
    import torch

    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.training.system import RowsCompactTrainer

    out = {}
    system = AnimNeRFSystem(dict(FLAGSHIP_CFG, compute_dtype="float32"),
                            smpl_rig(), device=dev, seed=0)
    trainer = RowsCompactTrainer(system, steps_per_epoch=100)
    batches = train_batches(16, 1024, range(F32_STEPS + 1), dev)
    trainer.step(batches[F32_STEPS])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []

    def one_step(b):
        t0 = time.perf_counter()
        d = trainer.step(b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(finite(trainer, d), "f32 step: non-finite loss or gradient")
        return d

    launches = with_launches(lambda: [one_step(b) for b in
                                      batches[:F32_STEPS]])[1]
    check(launches["fused_mlp"] > 0 and launches["fused_mlp_bwd"] > 0
          and launches["fused_mlp_wgrad"] == 0,
          f"f32 step: kernels 3 and 6 in f32 not launched: {launches}")
    out["step"] = dict(
        rays=16 * 1024, steps=F32_STEPS, ms=times,
        median_ms=float(np.median(times)),
        peak_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=launches,
        profile=profile_call(lambda: trainer.step(batches[0]), "step",
                             by_kernel=True))
    del system, trainer, batches
    torch.cuda.empty_cache()

    ck, _, bp, tmpl, _ = scale512("cpu")
    system = scale512_system(ck, dev, compute_dtype="float32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    views, vlaunches, _, _ = render_turntable(
        system, bp, tmpl, [F32_VIEW] * F32_VIEWS, profile=False)
    check(vlaunches["fused_mlp"] > 0,
          f"f32 view: kernel 3 in f32 not launched: {vlaunches}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    renderer_prof = profile_call(
        view_fn(system, bp, tmpl, F32_VIEW), "view", by_kernel=True)
    out["view"] = dict(
        view=F32_VIEW, size=[512, 512], ms=[v["ms"] for v in views],
        median_ms=float(np.median([v["ms"] for v in views])),
        survivors=[[v["n_coarse"], v["n_fine"]] for v in views],
        peak_allocated_gib=peak, launches=vlaunches, profile=renderer_prof)
    del system
    torch.cuda.empty_cache()
    return out


def _grad_groups(system):
    import torch

    groups = {"field": system.scene.nerf, "fine_field": system.scene.nerf_fine,
              "derf": system.scene.derf, "body_params": system.body_params}
    params = {k: list(m.parameters()) for k, m in groups.items()
              if m is not None}
    if system.latent_codes is not None:
        params["latent_codes"] = [system.latent_codes]
    # a parameter the rig does not use has no gradient (the SMPL-X
    # expression with 10 shape directions): zeros on both sides
    return {k: torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).detach().reshape(-1)
                          .cpu().double() for p in ps])
            for k, ps in params.items()}


# train_parity's bounds. f32: the kernels and the plain versions sum in
# other orders (per-split partials in the MLP backward, cuBLAS vs CPU
# matmuls in the geometry and the plain MLP), and last-bit geometry
# differences flip discrete choices of the step (a sample's validity at
# the dis_threshold edge, an inverse-CDF bin); the normal term
# differentiates a 2^9-frequency encoding at jittered template vertices.
# bf16: besides, tensor-core and CPU sum orders flip bf16 roundings
# between layers.
TRAIN_PARITY_BOUNDS = {
    "float32": dict(loss_rtol=1e-3, grad_rel_l2=2e-2, param_abs=1e-5),
    "bfloat16": dict(loss_rtol=2e-2, grad_rel_l2=1e-1, param_abs=1e-4)}


def train_parity(dev, cfg=FLAGSHIP_CFG, make_rig=smpl_rig,
                 model_type: str = "smpl", B: int = 2, R: int = 128,
                 grad_bounds: dict = None, check_grads: bool = True):
    """One full-width step with B x R rays on the card (kernels) and on the
    CPU (plain versions) from the same parameters and noise, through the
    engine the config takes (``make_trainer``). ``grad_bounds``: {dtype:
    {gradient group: rel-L2 bound}} in place of the dtype's bound for
    those groups; ``check_grads`` False checks the loss terms alone (a
    reference run whose gradient spread another run is held to)."""
    import torch

    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.training.system import make_trainer
    from animnerf_tpu_torch.utils.rng import draw_noise

    out = {}
    for dtype, bd in TRAIN_PARITY_BOUNDS.items():
        cfg_d = dict(cfg, compute_dtype=dtype,
                     train={"optimizer": {"type": "sgd", "momentum": 0.9}})
        res = {}
        for dv in (dev, "cpu"):
            system = AnimNeRFSystem(cfg_d, make_rig(), device=dv, seed=0)
            noise = draw_noise(torch.Generator().manual_seed(7), B, R,
                               system.renderer_cfg,
                               system.body_model.num_verts).to(dv)
            trainer = make_trainer(system, steps_per_epoch=100)
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
        gbound = {k: (grad_bounds or {}).get(dtype, {}).get(
            k, bd["grad_rel_l2"]) for k in grad_rel}
        out[dtype] = dict(loss_gpu=dg["loss"], loss_cpu=dc["loss"],
                          max_loss_term_rel=loss_rel, grad_rel_l2=grad_rel,
                          max_param_abs_after_sgd=param_abs,
                          engine=trainer.engine,
                          compact_count=[dg.get("compact_count"),
                                         dc.get("compact_count")], bounds=bd,
                          **({"grad_bounds": gbound} if grad_bounds else {}))
        # the parameters after one SGD step follow the gradients: where a
        # group's gradient bound is widened, so is the step's parameter
        # bound, by the same factor
        widen = max(gbound[k] / bd["grad_rel_l2"] for k in gbound)
        check(loss_rel <= bd["loss_rtol"]
              and (not check_grads
                   or (all(grad_rel[k] <= gbound[k] for k in grad_rel)
                       and param_abs <= bd["param_abs"] * widen)),
              f"train parity {dtype}: {out[dtype]}")
    return out


def with_launches(fn):
    """fn() with the launch counts set to 0 just before and read just
    after: (its result, the counts)."""
    from animnerf_tpu_torch.ops import _build

    reset_counts()
    res = fn()
    return res, dict(_build.LAUNCHES)


# the codes step at 10 frequencies: the JAX package's own spread of its
# gradients, jitted against op by op, measured by
# tests/test_torch_codes_spread.py (rel-L2 by group: DeRF, latent codes,
# the largest of the body params'), and the multiple of it the card may
# differ from the CPU by (that test's MULT)
CODES10_SPREAD = {"derf": 0.299, "latent_codes": 0.355, "body_params": 0.431}
CODES10_MULT = 2.0
# freqs_train_parity: the fused step's gradients within this multiple of
# the plain-MLP step's spread card against CPU, where that is the larger
FREQS_MULT = 2.0



def freqs_train_parity() -> dict:
    """Training steps card against CPU at the MLP backward's other
    encodings (flagship config at freqs_xyz 4 and 16, fused MLP), each
    with its launch counts. First the same step without the fused MLP
    (``fused_mlp: off``: the plain MLP on the card and on the CPU, no
    kernel 3 or 6), whose gradient spread card against CPU says how far
    the two devices' roundings alone carry the step: at 16 frequencies
    the field's second derivative at random weights moves the f32 body
    gradients by ~12% there (the JAX package's own jitted against op by
    op differs by 3-4% on the tiny rig, tests/test_torch_codes_spread.py).
    The fused step is held to the flagship step's bounds, or to
    FREQS_MULT times that spread where it is larger."""
    out = {}
    for nf in MLP_BWD_FREQS:
        ref = train_parity("cuda", dict(FLAGSHIP_CFG, freqs_xyz=nf,
                                        fused_mlp="off"), check_grads=False)
        bounds = {dt: {g: FREQS_MULT * v for g, v in
                       ref[dt]["grad_rel_l2"].items()} for dt in ref}
        res, launches = with_launches(lambda: train_parity(
            "cuda", dict(FLAGSHIP_CFG, freqs_xyz=nf), grad_bounds={
                dt: {g: max(b, TRAIN_PARITY_BOUNDS[dt]["grad_rel_l2"])
                     for g, b in gb.items()}
                for dt, gb in bounds.items()}))
        res["plain_mlp_spread"] = {dt: ref[dt]["grad_rel_l2"] for dt in ref}
        check(launches["fused_mlp_bwd"] > launches["fused_mlp_wgrad"] > 0,
              f"freqs_xyz {nf} step: the MLP backward did not launch in "
              f"both dtypes: {launches}")
        out[nf] = dict(res, launches=launches)
    return out


def wide_k_phases(ck, bp, tmpl) -> dict:
    """The main paths at k_neigh 24 and 40 (kernels 8, 2, 5 on the SMPL rigs,
    kernel 9 on SMPL-X; every kNN launch on the warp-per-point kernels
    above their thresholds), card against CPU, each with its launch counts:
    one training step (the rigid rig, so that several neighbours blend)
    within the flagship step's bounds, a 64x64 view (the scale512 weights
    on the seeded rig, both dtypes' bounds; at 24) and a 32x32 SMPL-X view
    (f32; the exact kNN's plain version on the CPU loops k x V / 512 times
    a 400-point chunk). Every warp-blend launch of those paths must run
    the group kernel."""
    from animnerf_tpu_torch.ops.knn_kernel import (
        EXACT_WIDE_ABOVE,
        PACKED_WIDE_ABOVE,
    )
    from animnerf_tpu_torch.ops.warp_blend import WARP_GROUP_ABOVE

    out = {}
    for k in (24, 40):
        cfg = dict(FLAGSHIP_CFG, k_neigh=k)
        res, launches = with_launches(lambda: train_parity(
            "cuda", cfg, rigid_smpl_rig))
        check(all(launches[n] > 0 for n in ("knn_packed", "warp_blend",
                                             "scatter", "fused_mlp_bwd"))
              and launches["knn_packed_wide"] == (
                  launches["knn_packed"] if k > PACKED_WIDE_ABOVE else 0)
              and launches["warp_blend_group"] == (
                  launches["warp_blend"] if k > WARP_GROUP_ABOVE else 0)
              and launches["knn"] == launches["knn_exact"] == 0,
              f"k_neigh {k} step launched the wrong kernels: {launches}")
        out[f"k{k}_train_parity"] = dict(res, launches=launches)
        if k == 24:
            res, launches = with_launches(lambda: slice_parity(
                ck, bp, tmpl, H=64, W=64, k_neigh=k))
            check(launches["knn_packed"] > 0 and launches["knn"] == 0
                  and launches["knn_packed_wide"] == (
                      launches["knn_packed"] if k > PACKED_WIDE_ABOVE
                      else 0)
                  and launches["warp_blend_group"] == (
                      launches["warp_blend"] if k > WARP_GROUP_ABOVE else 0),
                  f"k_neigh {k} view launched the wrong kNN: {launches}")
            out[f"k{k}_serve_parity"] = dict(res, launches=launches)
        res, launches = with_launches(lambda: smplx_serve_parity(
            H=32, W=32, cfg=dict(SMPLX_CFG, k_neigh=k),
            bounds=PARITY_BOUNDS[1:]))
        check(launches["knn_exact"] > 0
              and launches["knn_exact_wide"] == (
                  launches["knn_exact"] if k > EXACT_WIDE_ABOVE else 0)
              and launches["warp_blend_group"] == (
                  launches["warp_blend"] if k > WARP_GROUP_ABOVE else 0)
              and launches["knn"] == launches["knn_packed"] == 0,
              f"SMPL-X k_neigh {k} launched the wrong kNN: {launches}")
        out[f"k{k}_smplx_parity"] = dict(res, launches=launches)
    return out


# the k_neigh main paths profiled: timed steps and views a path
WIDE_PROFILE_STEPS = 5
WIDE_PROFILE_VIEWS = 3


def wide_k_profile(ck, bp, tmpl, k: int = 40) -> dict:
    """The main paths at k_neigh k on the card, timed and profiled: the
    bench.py step (16 x 1024 rays through ``RowsCompactTrainer.step`` on
    the rigid seed-0 SMPL rig: kernel 8, kernels 2 and 5 at K = k), the
    scale512 view 29 at 512x512 (kernel 8, kernel 2) and an SMPL-X view
    29 at 512x512 with the exact pre-pass (kernel 9; random weights, an
    opaque shell). For each: a warm-up, the launch counts of one call, the
    host-clock times of the next calls (each synchronised) and one
    profiled call (``profile_call``: device busy time, the kNN's ms and
    share). Uses nothing the port's earlier checkouts lack, so that
    tools/ab_wide_knn.py can run it on a parent."""
    import torch

    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.training.system import RowsCompactTrainer

    def measure(fn, n):
        fn()
        torch.cuda.synchronize()
        _, launches = with_launches(fn)
        torch.cuda.synchronize()
        ms = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return {"median_ms": float(np.median(ms)), "ms": ms,
                "launches": launches, "profile": profile_call(fn, "call")}

    out = {"k_neigh": k}
    system = AnimNeRFSystem(dict(FLAGSHIP_CFG, k_neigh=k), rigid_smpl_rig(),
                            device="cuda", seed=0)
    trainer = RowsCompactTrainer(system, steps_per_epoch=100)
    batches = train_batches(16, 1024, range(WIDE_PROFILE_STEPS + 3), "cuda",
                            "smpl")
    turn = iter(range(10 ** 6))

    def step():
        d = trainer.step(batches[next(turn) % len(batches)])
        check(finite(trainer, d), f"k_neigh {k} step: non-finite")

    out["step"] = measure(step, WIDE_PROFILE_STEPS)
    del system, trainer, batches
    view = view_fn(scale512_system(ck, "cuda", k_neigh=k), bp, tmpl, 29)
    out["view"] = measure(view, WIDE_PROFILE_VIEWS)
    xsystem = AnimNeRFSystem(dict(SMPLX_CFG, k_neigh=k), smplx_rig(),
                             device="cuda", seed=0)
    opaque_shell(xsystem)
    view = view_fn(xsystem, smplx_params(1, 1),
                   smplx_params(1, 2, zero_transl=True), 29, prepass="exact")
    out["smplx_view"] = measure(view, WIDE_PROFILE_VIEWS)
    del xsystem, view
    torch.cuda.empty_cache()
    return out


# the k_neigh 40 views' warp-blend calls: the plain version is timed in
# chunks of this many points (the whole call's gathered table rows would
# take tens of GB at once)
K40_PLAIN_CHUNK = 1 << 19


def k40_view_calls(ck, bp, tmpl, H: int = 512, W: int = 512) -> dict:
    """Kernel 2 on the calls of the k_neigh 40 views (scale512's view 29
    and the SMPL-X view 29 of ``wide_k_profile``), each call captured: its
    shape, the kernel's time (CUDA events), its bound (inputs read once,
    outputs written once, as ``warp_blend_call_line`` counts them), the
    gathered table bytes, and the plain version's time summed over
    K40_PLAIN_CHUNK-point chunks, each chunk within 1e-4 of the kernel."""
    import torch

    from animnerf_tpu_torch.ops.warp_blend import (
        warp_blend_fwd,
        warp_blend_fwd_plain,
    )
    from animnerf_tpu_torch.system import AnimNeRFSystem

    xsystem = AnimNeRFSystem(dict(SMPLX_CFG, k_neigh=40), smplx_rig(),
                             device="cuda", seed=0)
    opaque_shell(xsystem)
    views = {"smpl": view_fn(scale512_system(ck, "cuda", k_neigh=40), bp,
                             tmpl, 29, H, W),
             "smplx": view_fn(xsystem, smplx_params(1, 1),
                              smplx_params(1, 2, zero_transl=True), 29, H, W,
                              prepass="exact")}
    out = {}
    for name, view in views.items():
        view()
        calls = capture_warp_blend(view, keep=8)
        lines = []
        for c in calls:
            args = c["args"]
            rows, d, idx, table, num_lbs = args[:5]
            B, K, N = idx.shape
            F = table.shape[2]
            in_bytes = (3 * N + 2 * K * N) * B * 4 + table.numel() * 4
            bound = (in_bytes + B * N * (8 + K + 16) * 4) / PEAK_BYTES * 1e3
            ms = time_ms(lambda: warp_blend_fwd(*args), 10)
            full = warp_blend_fwd(*args)[0]
            plain_ms, err = 0.0, 0.0
            for s0 in range(0, N, K40_PLAIN_CHUNK):
                sl = slice(s0, s0 + K40_PLAIN_CHUNK)
                part = (rows[..., sl].contiguous(), d[..., sl].contiguous(),
                        idx[..., sl].contiguous()) + tuple(args[3:])
                plain_ms += time_ms(lambda: warp_blend_fwd_plain(*part), 1,
                                    warmup=1)
                o = warp_blend_fwd_plain(*part)[0]
                err = max(err, float((o - full[..., sl]).abs().max()))
                del o
            check(err <= 1e-4, f"k_neigh 40 {name} warp-blend call: {err}")
            lines.append(dict(shape=f"knn ({B},{K},{N}) table "
                                    f"{tuple(table.shape)}",
                              ms=ms, bound_ms=bound, bound_by="bytes",
                              pct_of_bound=100.0 * bound / ms,
                              gathered_bytes=B * N * K * F * 4,
                              plain_ms=plain_ms, max_abs_err=err))
            del full
        out[name] = {"calls": lines,
                     "ms": sum(ln["ms"] for ln in lines),
                     "bound_ms": sum(ln["bound_ms"] for ln in lines),
                     "plain_ms": sum(ln["plain_ms"] for ln in lines)}
        del calls
    del xsystem, views
    torch.cuda.empty_cache()
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
    # its device time from the profiler (the kernel alone: its device
    # time summed over the launches the trace holds, over their count;
    # the trace drops some of a kernel this short), beside the CUDA-event
    # time of back-to-back wrapper calls, which also counts the host's
    # launch path (ctypes, the flags' allocation, the counters' lookup)
    # whenever the host, not the card, sets the pace
    split = kernel_split(lambda: _far_pass(pts, verts, thr, d, i, True,
                                           tbox=tbox), ("knn_far_kernel",),
                         reps=20)
    check(split["launches"] > 0, f"far pass: no launch in the trace: {split}")
    device_ms = split["ms"] / split["launches"]
    nbytes = N * 12 + skip.numel() * 4 + n_skip * 32
    bound = far_bound_ms(N, V, 0, 0.0, nbytes)
    nbytes_ms = nbytes / PEAK_BYTES * 1e3
    return dict(shape=f"points (1,{N},3) verts (1,{V},3) K=4 packed",
                max_abs_err=float((d[m] - dp[m]).abs().max())
                if n_skip else 0.0, tolerance=0.0, bit_equal=same,
                skipped_share=float(skip.float().mean()),
                ms=device_ms, device_ms=device_ms,
                profiled_launch_share=split["launches"],
                event_ms=time_ms(lambda: _far_pass(pts, verts, thr, d, i,
                                                   True, tbox=tbox), reps),
                plain_ms=s.elapsed_time(e), bound_ms=bound,
                bound_by="operations" if bound > nbytes_ms else "bytes",
                pct_of_bound=100.0 * bound / device_ms, library_ms=None,
                library_call="none: no single PyTorch call computes the "
                             "tile-box bound, the group minimum and the "
                             "skipped outputs")


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
                bound_by="operations", library_ms=library_knn_ms(pts, verts,
                                                                 k),
                library_call="torch.cdist + torch.topk, 32768-point chunks")


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
                bound_by="operations", library_ms=library_knn_ms(pts, verts,
                                                                 4),
                library_call="torch.cdist + torch.topk, 32768-point chunks")


def kernel_lines_edge_far(dev, thr: float = 0.2) -> dict:
    """Kernels 1 (with and without the tile skip), 8 and 9 with the far skip at
    N = 2^20 - 37 points (the last group partial), K in {1, 4, 8, 16, 40}
    (40: the warp-per-point kernels): half the points near a seeded cloud
    (0.3 m) around the origin, the other half (the last group's among them)
    5 m away; the last group's padding points at the origin keep it from
    skipping. Then the cloud moved 3 m from the origin, where the last
    group skips. Each output bit-equal to its plain version with the far
    skip."""
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
                    for K in ((1, 4, 8, 16, 40) if cloud == "origin"
                              else (8, 40))]
            else:
                runs += [("knn_exact", K, lambda K: knn_exact(
                    pts, verts, K, far_skip=thr), lambda K: knn_exact_plain(
                        pts, verts, K, PLAIN_EXACT_MAX_ELEMS, thr))
                    for K in ((1, 4, 8, 16, 40) if cloud == "origin"
                              else (4,))]
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


# ------------------------------------------------------- the split path

# the flagship rig and field (FLAGSHIP_CFG) with the reference's other
# options: view directions warped with the points, latent codes + DeRF,
# more than 128 samples a ray with depth-guided ones, a shared fine field
VIEW_CFG = dict(FLAGSHIP_CFG, use_view=True, freqs_dir=4, unpose_view=True)
CODES_CFG = dict(FLAGSHIP_CFG, use_deformation=True, deformation_dim=16,
                 apperance_dim=16)
WIDE_CFG = dict(FLAGSHIP_CFG, n_samples=128, n_importance=64, n_depth=16)
SHARE_CFG = dict(FLAGSHIP_CFG, share_fine=True)
# the dense view step: kNN, warp-blend with warp_view, its backward's
# scatter, sample_fine's lane gather; the field is the plain MLP
VIEW_TRAIN_KERNELS = ("knn", "warp_blend", "warp_blend_view_dir", "scatter",
                      "permute_lanes")
VIEW_SERVE_KERNELS = ("knn", "warp_blend", "warp_blend_view_dir",
                      "permute_lanes")
OFF_SMPL = ("knn_exact", "min_dist", "knn_packed")
VIEW_DIR_POINTS = 1 << 20
# split_serve's parity shapes: the compacted view route at 96x96, the
# split eval route at 32x32 (the CPU renders every sample of every ray:
# 64x64 took ~2.5 min of the run, most of it the wide config's CPU side)
SPLIT_PARITY_VIEW = 96
SPLIT_PARITY_EVAL = 32


def split_params():
    """Seeded SMPL body params (seed 1) and template params (seed 2,
    zero translation), numpy (1, dim) each."""
    from animnerf_tpu_torch.data.synthetic import random_pose_params

    bp = random_pose_params(24, batch=1, seed=1)
    tmpl = random_pose_params(24, batch=1, seed=2)
    bp["transl"] = np.zeros_like(bp["transl"])
    tmpl["transl"] = np.zeros_like(tmpl["transl"])
    return bp, tmpl


def split_system(cfg: dict, dev, opaque: bool = False):
    """The field of ``cfg`` at seed-0 random weights on the seed-0 SMPL
    rig (``opaque``: both sigma biases raised by 30, opaque_shell)."""
    import torch

    from animnerf_tpu_torch.system import AnimNeRFSystem

    system = AnimNeRFSystem(cfg, smpl_rig(), device=dev, seed=0)
    if opaque:
        with torch.no_grad():
            for net in (system.scene.nerf, system.scene.nerf_fine):
                if net is not None:
                    net.sigma.bias += 30.0
    return system


def warp_view_lines(dev) -> dict:
    """``warp_blend_view_dir``: kernel 2 with warp_view on (1, 2^20)
    points about the seeded SMPL body (vertices + N(0, 0.05)), unit view
    directions, their kNN on the Morton cloud, at K = 4 and 8: the
    forward line (warp_blend_call_line), then one backward of the point
    form (d_xyz, d_viewdir, d_table) against autograd through the plain
    version on the same inputs: d_xyz and d_viewdir within 1e-4 of
    1 + their largest value, d_table within rel-L2 1e-5 (f32 sums in
    another order, as the weighted scatter's lines)."""
    import torch

    from animnerf_tpu_torch.models.warp import prepare_frame
    from animnerf_tpu_torch.ops.knn_kernel import knn
    from animnerf_tpu_torch.ops.warp_blend import (
        warp_blend,
        warp_blend_fwd_plain,
    )

    bp, tmpl = split_params()
    bm = smpl_rig().to(dev)
    with torch.no_grad():
        ctx = prepare_frame(bm, tensors(bp, dev), tensors(tmpl, dev))
    g = torch.Generator(device=dev).manual_seed(0)
    V = ctx.verts.shape[1]
    N = VIEW_DIR_POINTS
    pick = torch.randint(0, V, (N,), generator=g, device=dev)
    pts = (ctx.verts[:, pick] + 0.05 * torch.randn(
        (1, N, 3), generator=g, device=dev)).contiguous()
    vd = torch.randn((1, N, 3), generator=g, device=dev)
    vd = vd / vd.norm(dim=-1, keepdim=True)
    J = ctx.lbs_weights.shape[1]
    table = ctx.table_morton.contiguous()
    out = {}
    for K in (4, 8):
        d, i = knn(pts, ctx.verts_morton, K)
        rows = torch.cat([pts.transpose(1, 2), pts.new_zeros(1, 1, N),
                          vd.transpose(1, 2), pts.new_zeros(1, 1, N)], 1)
        line = warp_blend_call_line((rows.contiguous(), d, i, table, J, 0.1,
                                     0.9), warp_view=True)
        ct = torch.randn((2, 1, N, 3), generator=g, device=dev)
        grads = {}
        for mode in ("kernel", "plain"):
            x = pts.clone().requires_grad_()
            v = vd.clone().requires_grad_()
            t = table.clone().requires_grad_()
            if mode == "kernel":
                cano, vo, _ = warp_blend(x, v, d, i, t, J, 0.1, 0.9,
                                         warp_view=True, inputs_t=True)
            else:
                r = torch.cat([x.transpose(1, 2), x.new_zeros(1, 1, N),
                               v.transpose(1, 2), x.new_zeros(1, 1, N)], 1)
                o = warp_blend_fwd_plain(r, d, i, t, J, 0.1, 0.9,
                                         residuals=False, warp_view=True)[0]
                cano, vo = o[:, 0:3].transpose(1, 2), o[:, 4:7].transpose(1, 2)
            ((cano * ct[0]).sum() + (vo * ct[1]).sum()).backward()
            grads[mode] = (x.grad, v.grad, t.grad)
        (gx, gv, gt), (px, pv, pt) = grads["kernel"], grads["plain"]
        errs = {"d_xyz_max_abs": float((gx - px).abs().max()),
                "d_viewdir_max_abs": float((gv - pv).abs().max()),
                "d_table_rel_l2": float((gt - pt).norm() / pt.norm())}
        bounds = {"d_xyz_max_abs": 1e-4 * (1 + float(px.abs().max())),
                  "d_viewdir_max_abs": 1e-4 * (1 + float(pv.abs().max())),
                  "d_table_rel_l2": 1e-5}
        check(all(errs[k] <= bounds[k] for k in errs),
              f"warp_view backward K={K}: {errs} (bounds {bounds})")
        line["backward"] = dict(errs, bounds=bounds)
        out[K] = line
        del grads, gx, gv, gt, px, pv, pt
    return out


def dense_train(dev, cfg: dict, n_timed: int, need=(), absent=OFF_SMPL,
                engine: str = "dense", profile: bool = False,
                B: int = 16, R: int = 1024) -> dict:
    """Steps of the engine ``make_trainer`` picks for ``cfg`` (it must be
    ``engine``) on the bench.py batch: one warm-up step, ``n_timed``
    steps on distinct batches, synchronised, with the launch counts and
    the peak of allocated device memory reset just before and read just
    after (every kernel of ``need`` launched, none of ``absent``), then
    (``profile``) one profiled step."""
    import torch

    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.training.system import make_trainer

    system = split_system(cfg, dev)
    trainer = make_trainer(system, steps_per_epoch=100)
    check(trainer.engine == engine,
          f"{cfg}: the {trainer.engine} engine, not {engine}")
    batches = train_batches(B, R, range(n_timed + 1), dev)
    trainer.step(batches[n_timed])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    steps = []
    for s in range(n_timed):
        t0 = time.perf_counter()
        d = trainer.step(batches[s])
        torch.cuda.synchronize()
        ok = finite(trainer, d)
        steps.append(dict(step=s, ms=(time.perf_counter() - t0) * 1e3,
                          loss=float(d["loss"]), psnr=float(d["psnr"]),
                          finite=ok))
        check(ok, f"{engine} step {s}: non-finite loss or gradient")
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(all(launches[k] > 0 for k in need)
          and all(launches[k] == 0 for k in absent),
          f"{engine} steps launched the wrong kernels: {launches}")
    med = float(np.median([st["ms"] for st in steps]))
    out = {"engine": engine, "rays_per_step": B * R, "steps": steps,
           "median_step_ms": med, "train_rays_per_s": B * R / (med / 1e3),
           "peak_allocated_gib": peak / 2 ** 30,
           "remat": system.scene_cfg.remat,
           "fused_mlp": system.scene.use_fused_mlp,
           "launches": launches,
           "launches_per_step": {k: v / n_timed for k, v in launches.items()
                                 if v}}
    if profile:
        out["profile"] = profile_call(lambda: trainer.step(batches[0]),
                                      "step")
    return out


def split_train(dev) -> dict:
    """The dense view step at full width (10 timed, profiled), then 3
    steps each of the codes (dense), wide (dense) and shared-fine (rows
    engine) configurations."""
    out = {"view": dense_train(dev, VIEW_CFG, 10, VIEW_TRAIN_KERNELS,
                               OFF_SMPL + ("fused_mlp",), profile=True)}
    out["codes"] = dense_train(dev, CODES_CFG, 3,
                               ("knn", "warp_blend", "scatter"),
                               OFF_SMPL + ("fused_mlp",
                                           "warp_blend_view_dir"))
    out["wide"] = dense_train(dev, WIDE_CFG, 3,
                              ("knn", "warp_blend", "scatter", "fused_mlp",
                               "fused_mlp_bwd"),
                              OFF_SMPL + ("warp_blend_view_dir",))
    out["share_fine"] = dense_train(dev, SHARE_CFG, 3, TRAIN_KERNELS,
                                    OFF_SMPL, engine="rows")
    return out


def eval_frame(system, bp, tmpl, H: int, W: int, frame_idx: int = 1):
    """A function rendering one H x W frame through ``make_eval_step`` in
    slabs of MAX_RAYS_PER_CALL rays with the frame's codes -> outputs."""
    import torch

    from animnerf_tpu_torch.render.inference import MAX_RAYS_PER_CALL
    from animnerf_tpu_torch.training.system import make_eval_step

    dev = system.device
    rays = torch.tensor(frame_rays(H, W), device=dev)
    base = {"frame_idx": torch.tensor([frame_idx], device=dev),
            **tensors(bp, dev),
            **{k + "_template": v for k, v in tensors(tmpl, dev).items()}}
    step = make_eval_step(system)

    def frame():
        parts = [step(dict(base, rays=rays[None, s:s + MAX_RAYS_PER_CALL]))
                 for s in range(0, rays.shape[0], MAX_RAYS_PER_CALL)]
        return {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}

    return frame


def split_serve() -> dict:
    """The view config through Renderer.render_stream at 512x512
    (compacted route: kernels 1, 2 with warp_view, 4; the plain MLP),
    views 3, 29, 55 with a profiled view; ``make_eval_step`` on one
    512x512 frame of the codes and of the wide config (split route), a
    warm-up slab first, the frame with the launch counts reset just
    before and read just after, one profiled frame; then card against
    CPU: the view config's view at 96x96 (Renderer), the codes and wide
    frames at 32x32 (eval step), within PARITY_BOUNDS: both dtypes, but
    the wide config in f32 only (its field is kernel 3, whose bf16 card
    against CPU slice_parity holds; what it adds is the split route past
    128 samples and the depth-guided samples)."""
    import torch

    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.render.inference import (
        Renderer,
        turntable_rotation,
    )

    bp, tmpl = split_params()
    out: dict = {}
    system = split_system(VIEW_CFG, "cuda", opaque=True)
    views, launches, prof, _ = render_turntable(system, bp, tmpl,
                                                [3, 29, 55])
    check(all(launches[k] > 0 for k in VIEW_SERVE_KERNELS)
          and all(launches[k] == 0 for k in OFF_SMPL + ("fused_mlp",)),
          f"view serving launched the wrong kernels: {launches}")
    out["view"] = {"views": views, "median_view_ms": float(np.median(
        [v["ms"] for v in views])), "launches": launches,
        "launches_per_view": {k: v / len(views) for k, v in launches.items()
                              if v}, "profile": prof}
    del system
    for name, cfg in (("codes", CODES_CFG), ("wide", WIDE_CFG)):
        system = split_system(cfg, "cuda", opaque=True)
        check(not system.rows_renderable(), f"{name} is rows-renderable")
        frame = eval_frame(system, bp, tmpl, 512, 512)
        eval_frame(system, bp, tmpl, 64, 64)()  # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = frame()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.LAUNCHES)
        key = "rgbs" if cfg.get("share_fine") else "rgbs_fine"
        alpha = res["alphas_fine"][0, :, 0]
        ok = all(bool(torch.isfinite(v).all()) for v in res.values())
        body = int((alpha > 0.5).sum())
        check(ok and body > 500 and res[key].shape == (1, 512 * 512, 3),
              f"{name} eval frame: finite {ok}, body {body} px")
        check(all(launches[k] > 0 for k in ("knn", "warp_blend"))
              and launches["permute_lanes"] + launches["fused_mlp"] > 0
              and all(launches[k] == 0 for k in OFF_SMPL),
              f"{name} eval launched the wrong kernels: {launches}")
        out[name] = {"frame_ms": ms, "rays": 512 * 512, "body_px": body,
                     "samples_per_ray": system.renderer_cfg.n_coarse
                     + system.renderer_cfg.n_fine
                     + system.renderer_cfg.n_fine_depth,
                     "launches": launches,
                     "profile": profile_call(frame, "frame")}
        del system, res
    parity = {}
    for name, cfg, bounds in (("view", VIEW_CFG, PARITY_BOUNDS),
                              ("codes", CODES_CFG, PARITY_BOUNDS),
                              ("wide", WIDE_CFG, PARITY_BOUNDS[1:])):
        parity[name] = {}
        for dtype, bound in bounds:
            imgs = {}
            for dv in ("cuda", "cpu"):
                s = split_system(dict(cfg, compute_dtype=dtype), dv,
                                 opaque=True)
                if name == "view":
                    n = SPLIT_PARITY_VIEW
                    img, _, _ = Renderer(s, device=dv).render_frame(
                        bp, tmpl, frame_rays(n, n), turntable_rotation(17, 64),
                        (n, n))
                else:
                    n = SPLIT_PARITY_EVAL
                    with torch.no_grad():
                        img = eval_frame(s, bp, tmpl, n, n)()[
                            "rgbs_fine"][0].cpu().numpy()
                imgs[dv] = img
            d = image_diff(imgs["cuda"], imgs["cpu"])
            parity[name][dtype] = dict(d, shape=n, bound_max_abs=bound[0],
                                       bound_psnr_db=bound[1])
            check(d["max_abs"] <= bound[0] and d["psnr_db"] >= bound[1],
                  f"split parity {name} {dtype}: {d}")
    out["parity"] = parity
    return out


def split_fit(root: str) -> dict:
    """``fit`` on the fit phase's dataset with the view config (a few
    steps, the dense engine; kernels 1, 2 with warp_view, 5 launched),
    then ``cli.test`` and ``cli.novel_view`` (2 views) on its ``last``;
    then a fit of the codes config whose ``last`` (latent codes, DeRF)
    loaded into a fresh system gives the trained parameters bit for
    bit."""
    import torch

    from animnerf_tpu_torch.cli import novel_view
    from animnerf_tpu_torch.cli import test as test_cli
    from animnerf_tpu_torch.models.body_params import (
        load_body_params_from_dataset,
    )
    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.training import loop as TL
    from animnerf_tpu_torch.training.checkpoints import load_params

    out = {}
    for name, opts, steps in (
            ("view", ["use_view", "True", "freqs_dir", "4", "unpose_view",
                      "True"], 3),
            ("codes", ["use_deformation", "True", "deformation_dim", "16",
                       "apperance_dim", "16"], 2)):
        cfg = fit_config(root)
        cfg.merge_from_list(opts + ["exp_name", "fit_" + name,
                                    "train.max_steps", str(steps)])
        stats: dict = {}
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        ckpt_dir = TL.fit(cfg, device="cuda", stats=stats)
        fit_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        need = ("knn", "warp_blend", "scatter") + (
            ("warp_blend_view_dir",) if name == "view" else ())
        check(all(launches[k] > 0 for k in need),
              f"split fit {name}: launches {launches}")
        losses = [loss for _, loss in stats["losses"]]
        check(len(losses) == steps and all(map(math.isfinite, losses)),
              f"split fit {name} losses: {losses}")
        trained = {k: v.detach().clone() for k, v in
                   stats.pop("system").named_parameters()}
        last = os.path.join(ckpt_dir, "last")
        fresh = TL.build_system(cfg, "cuda")
        fresh.set_body_params(load_body_params_from_dataset(
            cfg.frame_IDs, cfg.root_dir, cfg.model_type))
        load_params(last, fresh)
        got = dict(fresh.named_parameters())
        same = sorted(got) == sorted(trained) and all(
            torch.equal(got[k], v) for k, v in trained.items())
        check(same, f"split fit {name}: last reloaded differs")
        del fresh, got, trained
        entry = {"steps": steps, "fit_s": fit_s, "losses": losses,
                 "median_step_ms": float(np.median(stats["step_s"])) * 1e3,
                 "last_reload_bit_equal": same, "launches": launches}
        if name == "codes":
            entry["has_latent_codes"] = os.path.isfile(os.path.join(
                last, "latent_codes.npz"))
            check(entry["has_latent_codes"], "no latent_codes.npz in last")
        else:
            t0 = time.perf_counter()
            scores = test_cli.main(["--ckpt_path", last])
            entry["test"] = dict(scores, seconds=time.perf_counter() - t0)
            check(all(map(math.isfinite, scores.values())),
                  f"cli.test on the view fit: {scores}")
            vstats: dict = {}
            _build.reset_launches()
            d = novel_view.main(["--ckpt_path", last, "--n_views", "2",
                                 "outputs_dir", os.path.join(root, "out")],
                                stats=vstats)
            nv = dict(_build.LAUNCHES)
            imgs = sorted(os.listdir(os.path.join(d, "images")))
            check(len(imgs) == 2 and nv["warp_blend_view_dir"] > 0,
                  f"novel_view on the view fit: {imgs}, {nv}")
            entry["novel_view"] = {"view_ms": [t * 1e3 for t in
                                               vstats["view_s"]],
                                   "launches": nv}
        out[name] = entry
    return out



# ------------------------------------------- data prep, checkpoints, compact

# prepare_template: 64^3 points against the seed-3 rig (scale512's) on the
# card; the card against the port's CPU path on the first PREP_CHECK of
# them (the same float64 operations in the same order; the CPU's
# vectorised sqrt is not always correctly rounded, so they differ by an
# ulp: 2.2e-16 relative on the H100 (PERF.md); PREP_REL is the stated
# bound); a sign may differ only within PREP_SIGN_BAND of the surface
PREP_POINTS = 64 ** 3
PREP_CHECK = 4096
PREP_REL = 1e-12
PREP_SIGN_BAND = 1e-9


def uv_sphere():
    """tests/test_tools.py's closed unit UV sphere, faces outward."""
    th = np.linspace(0, np.pi, 9)[1:-1]
    ph = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                    np.cos(tt)], -1).reshape(-1, 3)
    verts = np.concatenate([pts, [[0, 0, 1.0]], [[0, 0, -1.0]]])
    faces = []
    R, C = tt.shape
    for i in range(R - 1):
        for j in range(C):
            a, b = i * C + j, i * C + (j + 1) % C
            c, d = (i + 1) * C + j, (i + 1) * C + (j + 1) % C
            faces += [[a, b, c], [b, d, c]]
    top, bot = len(verts) - 2, len(verts) - 1
    for j in range(C):
        faces.append([top, (j + 1) % C, j])
        faces.append([bot, (R - 1) * C + j, (R - 1) * C + (j + 1) % C])
    faces = np.asarray(faces)
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    flip = (np.cross(b - a, c - a) * (a + b + c) / 3).sum(-1) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return verts, faces


def prepare_template_phase(device: str = "cuda", points: int = PREP_POINTS,
                           check_points: int = PREP_CHECK) -> dict:
    """The port's prepare_template on the card at full size: a subject of
    two seeded frame pickles on the seed-3 V=6890 rig (its 6,890 strip
    faces), a seeded X-pose, 64^3 points; its wall time (synchronised,
    the body model and the pickle included) and the distance pass's
    alone. The
    card against the CPU on the first PREP_CHECK points; the template's
    own float32 distances there equal the card's float64 ones rounded;
    the closed sphere on the card with tests/test_tools.py's four sign
    assertions."""
    import torch

    from animnerf_tpu_torch.data.synthetic import make_rig
    from animnerf_tpu_torch.ops.mesh_distance import (
        chunk_points,
        signed_distance,
    )
    from animnerf_tpu_torch.smpl.loader import load_pickle, save_model_data
    from animnerf_tpu_torch.tools.prepare_template import (
        prepare_template,
        template_points,
    )
    from animnerf_tpu_torch.utils.io import write_pickle_file

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="prep_smoke_",
                            dir=os.path.join(ROOT, "build"))
    try:
        rig = make_rig(6890, 24, seed=3)
        os.makedirs(os.path.join(root, "models"))
        save_model_data(os.path.join(root, "models", "SMPL_NEUTRAL.pkl"),
                        rig)
        os.makedirs(os.path.join(root, "subj", "smpls"))
        rng = np.random.default_rng(5)
        for i in range(2):
            write_pickle_file(
                os.path.join(root, "subj", "smpls", f"{i + 1:06d}.pkl"),
                {"betas": rng.normal(scale=0.3, size=(1, 10)).astype(
                    np.float32)})
        xpose = os.path.join(root, "X_pose.pkl")
        body_pose = np.zeros(69, np.float32)
        body_pose[[47, 50]] = [-1.0, 1.0]       # arms out, as an X
        body_pose[[2, 5]] = [0.5, -0.5]         # legs apart
        write_pickle_file(xpose, {"betas": np.zeros((1, 10), np.float32),
                                  "global_orient": np.zeros(3, np.float32),
                                  "body_pose": body_pose,
                                  "transl": np.zeros(3, np.float32)})
        sync(device)
        t0 = time.perf_counter()
        path = prepare_template(root, "subj", gender="neutral",
                                model_path=os.path.join(root, "models"),
                                template_path=xpose, num_points=points,
                                device=device)
        wall_s = time.perf_counter() - t0
        tmpl = load_pickle(path)
        verts, faces = tmpl["verts"], tmpl["faces"]
        check(tmpl["points"].shape == (points, 3)
              and tmpl["distances"].shape == (points,)
              and np.isfinite(tmpl["distances"]).all(),
              f"template: {tmpl['points'].shape} {tmpl['distances'].shape}")
        _, _, pts = template_points(verts, points, seed=0)
        check(np.array_equal(pts.astype(np.float32), tmpl["points"]),
              "template points differ from default_rng's draws")
        sync(device)
        t0 = time.perf_counter()
        signed_distance(pts, verts, faces, device=device)
        sync(device)
        dist_s = time.perf_counter() - t0
        sub = pts[:check_points]
        d_dev = signed_distance(sub, verts, faces, device=device).cpu()
        t0 = time.perf_counter()
        d_cpu = signed_distance(sub, verts, faces, device="cpu")
        cpu_s = time.perf_counter() - t0
        rel = float(((d_dev - d_cpu).abs() / d_cpu.abs().clamp_min(
            1e-300)).max())
        flips = torch.sign(d_dev) != torch.sign(d_cpu)
        band = float(d_cpu[flips].abs().max()) if flips.any() else 0.0
        check(rel <= PREP_REL and band <= PREP_SIGN_BAND,
              f"prepare_template card vs CPU: rel {rel}, sign band {band}")
        check(np.array_equal(d_dev.numpy().astype(np.float32),
                             tmpl["distances"][:check_points]),
              "template distances differ from the card's float64 ones")
        sv, sf = uv_sphere()
        q = np.array([[0, 0, 0], [0.5, 0, 0], [2.0, 0, 0], [0, 1.5, 0]],
                     np.float64)
        ds = signed_distance(q, sv, sf, device=device).cpu().numpy()
        sphere_ok = bool(ds[0] < -0.8 and ds[1] < 0 and 0.8 < ds[2] < 1.2
                         and 0.3 < ds[3] < 0.7)
        check(sphere_ok, f"sphere signs on the card: {ds}")
        d = tmpl["distances"]
        return {"points": points, "verts": int(len(verts)),
                "faces": int(len(faces)), "pairs": points * int(len(faces)),
                "chunk_points": chunk_points(len(faces)),
                "wall_s": wall_s, "distances_s": dist_s,
                "inside": int((d < 0).sum()), "outside": int((d > 0).sum()),
                "card_vs_cpu": {"points": check_points, "max_rel": rel,
                                "bit_equal": bool(torch.equal(d_dev, d_cpu)),
                                "sign_flips": int(flips.sum()),
                                "sign_band_m": band, "rel_bound": PREP_REL,
                                "sign_band_bound_m": PREP_SIGN_BAND,
                                "cpu_s": cpu_s},
                "sphere": ds.tolist(), "sphere_signs_ok": sphere_ok,
                "launches": "none: eager torch float64"}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _reference_name(layer: str) -> str:
    """A flax layer of the field -> the reference module's attribute."""
    if layer == "xyz_final":
        return "xyz_encoding_final"
    if layer == "dir_0":
        return "dir_encoding.0"
    if layer == "rgb":
        return "rgb.0"
    if layer == "sigma":
        return "sigma"
    return f"xyz_encoding_{int(layer[4:]) + 1}.0"


def yacs_cfgnode() -> type:
    """A stand-in for yacs' ``CfgNode``: a dict subclass whose dict
    sections become CfgNodes, yacs' attributes in ``__dict__``."""

    class CfgNode(dict):
        def __init__(self, init_dict=None):
            init_dict = dict(init_dict or {})
            for k, v in init_dict.items():
                if type(v) is dict:
                    init_dict[k] = CfgNode(v)
            super().__init__(init_dict)
            self.__dict__["__immutable__"] = False
            self.__dict__["__new_allowed__"] = False

    CfgNode.__module__, CfgNode.__qualname__ = "yacs.config", "CfgNode"
    return CfgNode


def write_reference_ckpt(path: str, nets: dict, body: dict,
                         hparams: dict) -> dict:
    """torch.save a Lightning checkpoint: the field's state dicts
    (``nets``: {net: {"<layer>.<weight|bias>": tensor}}) under the
    reference's names, ``body`` as body_model_params.*, the SMPL-buffer
    and evaluator decoys, ``hparams`` as a yacs ``CfgNode`` (the stand-in
    registered as ``yacs.config`` only while the file is written, as the
    card's machine has no yacs). Returns the state dict."""
    import types

    import torch

    sd = {}
    for net, state in nets.items():
        for name, t in state.items():
            layer, leaf = name.split(".")
            sd[f"anim_nerf.{net}.{_reference_name(layer)}.{leaf}"] = \
                torch.as_tensor(t).detach().cpu().clone()
    for k, v in body.items():
        sd[f"body_model_params.{k}.weight"] = torch.from_numpy(
            np.array(v))
    sd["anim_nerf.body_model.v_template"] = torch.zeros(6890, 3)
    sd["evaluator.lpips.net.slice1.0.weight"] = torch.zeros(64, 3, 11, 11)
    cls = yacs_cfgnode()
    saved = {m: sys.modules.get(m) for m in ("yacs", "yacs.config")}
    yacs, config = types.ModuleType("yacs"), types.ModuleType("yacs.config")
    config.CfgNode, yacs.config = cls, config
    sys.modules.update({"yacs": yacs, "yacs.config": config})
    try:
        torch.save({"state_dict": sd, "epoch": 3, "global_step": 60,
                    "hyper_parameters": cls(hparams)}, path)
    finally:
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
    return sd


def converted_bit_equal(conv: str, sd: dict, body: dict) -> tuple:
    """(every converted array equal to its source tensor (kernels
    transposed) with its dtype, the count of arrays)."""
    from animnerf_tpu_torch.utils.convert import NERF_LAYERS

    with np.load(os.path.join(conv, "anim_nerf.npz")) as data:
        nerf = {k: data[k] for k in data.files}
    with np.load(os.path.join(conv, "body_params.npz")) as data:
        cbody = {k: data[k] for k in data.files}
    same = sorted(nerf) == sorted(
        f"{net}/params/{layer}/{leaf}" for net in ("nerf", "nerf_fine")
        for layer in NERF_LAYERS for leaf in ("kernel", "bias"))
    for key, arr in nerf.items():
        net, _, layer, leaf = key.split("/")
        src = sd[f"anim_nerf.{net}.{_reference_name(layer)}."
                 f"{'weight' if leaf == 'kernel' else 'bias'}"].numpy()
        src = src.T if leaf == "kernel" else src
        same = same and arr.dtype == src.dtype and np.array_equal(arr, src)
    same = same and sorted(cbody) == sorted(body) and all(
        np.array_equal(cbody[k], body[k]) for k in body)
    return same, len(nerf) + len(cbody)


def convert_parity(root: str, last: str, lpips_weights: str,
                   device: str = "cuda") -> dict:
    """A Lightning .ckpt of the scale512 field and the fit run's body
    params with the fit config as hyper-parameters, a yacs ``CfgNode``
    (``write_reference_ckpt``), converted without torch's unpickler:
    every array bit-equal to its source tensor, the config with its
    sections in meta.json. Then parity_check with ``--ref_lpips`` on the
    fit dataset (the asset paths of this run winning) on the card, with
    ``$ANIMNERF_LPIPS_WEIGHTS`` at ``lpips_weights``: its PSNR, SSIM and
    LPIPS must equal ``evaluate`` on the original checkpoint (the same
    arrays written by save_params) exactly; the launch counts of each set
    to 0 just before and read just after."""
    import torch

    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.tools.convert_checkpoint import convert
    from animnerf_tpu_torch.tools.parity_check import run_parity_check
    from animnerf_tpu_torch.training import loop as TL
    from animnerf_tpu_torch.training.checkpoints import (
        load_metadata,
        nerf_params_to_flax,
        save_params,
    )
    from animnerf_tpu_torch.utils.convert import load_checkpoint

    ck = load_checkpoint(CKPT)
    nets = {net: {k: torch.as_tensor(v) for k, v in
                  ck["anim_nerf"][net].items()}
            for net in ("nerf", "nerf_fine")}
    with np.load(os.path.join(last, "body_params.npz")) as data:
        body = {k: data[k] for k in data.files}
    cfg = fit_config(root)
    hparams = json.loads(json.dumps(TL.dict_flat(cfg), default=list))
    ckpt = os.path.join(root, "reference.ckpt")
    sd = write_reference_ckpt(ckpt, nets, body, hparams)

    t0 = time.perf_counter()
    conv = convert(ckpt, os.path.join(root, "converted"))
    convert_s = time.perf_counter() - t0
    same, n_arrays = converted_bit_equal(conv, sd, body)
    check(same, "converted arrays differ from the reference checkpoint's")
    meta_cfg = load_metadata(conv).get("cfg")
    check(meta_cfg == hparams,
          "the CfgNode hyper-parameters did not reach meta.json as the "
          f"config: {sorted(meta_cfg or {})}")

    orig = os.path.join(root, "original")
    flax = {}
    for net, state in nets.items():
        flax.update(nerf_params_to_flax(state, net))
    save_params(orig, {"anim_nerf": flax, "body_params": body},
                {"cfg": TL.dict_flat(cfg)})
    with env_var("ANIMNERF_LPIPS_WEIGHTS", lpips_weights):
        sync(device)
        reset_counts()
        want = TL.evaluate(cfg, orig, device=device)
        eval_launches = dict(_build.LAUNCHES)
        reset_counts()
        t0 = time.perf_counter()
        got = run_parity_check(root, os.path.join(root, "models",
                                                  "SMPL_NEUTRAL.pkl"),
                               ckpt, ref_psnr=want["psnr"],
                               ref_ssim=want["ssim"],
                               ref_lpips=want["lpips"],
                               out_dir=os.path.join(root, "parity"),
                               device=device)
        parity_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    check(all(got[k] == want[k] for k in ("psnr", "ssim", "lpips"))
          and got["lpips_delta"] == 0.0,
          f"parity_check {got} against evaluate {want}")
    if device == "cuda":
        check(all(launches[k] > 0 for k in SERVE_KERNELS),
              f"parity_check's evaluate launched: {launches}")
    return {"arrays_bit_equal": same, "arrays": n_arrays,
            "cfg_sections": sorted(k for k, v in meta_cfg.items()
                                   if isinstance(v, dict)),
            "convert_s": convert_s, "parity_check_s": parity_s,
            "report": got, "evaluate_original": want, "launches": launches,
            "evaluate_launches": eval_launches}


@contextlib.contextmanager
def env_var(name: str, value: str):
    """``os.environ[name] = value`` for the block's length only."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


# lpips: the metric's weights from this seed; the card's score against the
# CPU's within LPIPS_REL relative (1e-5 predicted with TF32 off, ~1e-3 with
# it on); the pair timed over LPIPS_REPS CUDA-event runs
LPIPS_SEED = 21
LPIPS_REL = 1e-4
LPIPS_REPS = 20
LPIPS_PAIR = os.path.join(ROOT, "docs", "demo", "scale512", "fit_val.png")


def lpips_files(root: str, seed: int = LPIPS_SEED) -> tuple:
    """torchvision's alexnet features and lpips' alex.pth heads from a
    seed, torch.saved into root: (alexnet path, heads path, the npz arrays
    they must convert to)."""
    import torch

    from animnerf_tpu_torch.models.lpips import ALEX_LAYERS, TORCH_INDEX

    rng = np.random.default_rng(seed)
    alex, lin, want = {}, {}, {}
    cin = 3
    for i, (cout, kk, _, _) in enumerate(ALEX_LAYERS):
        ti = TORCH_INDEX[i]
        w = rng.normal(scale=0.05, size=(cout, cin, kk, kk)).astype(
            np.float32)
        b = rng.normal(scale=0.01, size=cout).astype(np.float32)
        h = rng.uniform(0, 0.1, size=(1, cout, 1, 1)).astype(np.float32)
        alex[f"features.{ti}.weight"] = torch.from_numpy(w)
        alex[f"features.{ti}.bias"] = torch.from_numpy(b)
        lin[f"lin{i}.model.1.weight"] = torch.from_numpy(h)
        want.update({f"conv{i}_w": w.transpose(2, 3, 1, 0),
                     f"conv{i}_b": b, f"lin{i}_w": h.reshape(-1)})
        cin = cout
    paths = (os.path.join(root, "alexnet.pth"), os.path.join(root, "alex.pth"))
    torch.save(alex, paths[0])
    torch.save(lin, paths[1])
    return paths[0], paths[1], want


def lpips_cost(H: int, W: int) -> tuple:
    """(the FP32 operations of one LPIPS pair at H x W: the five
    convolutions of both pictures, 2 per multiply-add; the bytes it must
    move: both pictures and the weights read once)."""
    from animnerf_tpu_torch.models.lpips import ALEX_LAYERS, POOL_AFTER

    flops, params, cin = 0.0, 0, 3
    for i, (cout, k, stride, pad) in enumerate(ALEX_LAYERS):
        H = (H + 2 * pad - k) // stride + 1
        W = (W + 2 * pad - k) // stride + 1
        flops += 2.0 * H * W * cout * cin * k * k
        params += cout * cin * k * k + 2 * cout
        if i in POOL_AFTER:
            H, W = (H - 3) // 2 + 1, (W - 3) // 2 + 1
        cin = cout
    return 2 * flops, 4.0 * (params + 2 * 3 * H * W)


def lpips_phase(cfg, last: str, fitted: dict, device: str = "cuda") -> dict:
    """LPIPS from weight files to the evaluation: seeded torch files
    converted (the .npz equal to the arrays saved); the scale512 run's
    validation render and its ground truth (512x512) scored on ``device``
    and on the CPU within LPIPS_REL, again with cuDNN's global TF32 switch
    on (the same score: LPIPS keeps its convolutions in float32), and
    with TF32 let into its convolutions (the trap, recorded); the pair's
    CUDA-event ms beside its FP32 bound; then ``evaluate`` of ``last``
    with ``$ANIMNERF_LPIPS_WEIGHTS`` set: lpips, and PSNR and SSIM equal
    to the fit phase's ``evaluate`` without it. Returns the line and the
    weights file."""
    import torch

    from animnerf_tpu_torch.models import lpips as L
    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.training import loop as TL
    from animnerf_tpu_torch.utils.image import read_png

    root = cfg.root_dir
    alex, heads, want = lpips_files(root)
    t0 = time.perf_counter()
    npz = L.convert_torch_lpips(alex, heads, os.path.join(root, "lpips.npz"))
    convert_ms = (time.perf_counter() - t0) * 1e3
    got = L.load_params(npz)
    same = sorted(got) == sorted(want) and all(
        got[k].dtype == np.float32 and np.array_equal(got[k], want[k])
        for k in want)
    check(same, "the converted LPIPS .npz differs from the arrays saved")

    panels = read_png(LPIPS_PAIR).astype(np.float32) / 255.0
    gt, pred = panels[:, :512], panels[:, 512:1024]
    H, W = gt.shape[:2]
    card = L.LPIPSMetric(npz, device)
    cpu = L.LPIPSMetric(npz, "cpu")
    score = card(pred, gt)
    t0 = time.perf_counter()
    score_cpu = cpu(pred, gt)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    rel = abs(score - score_cpu) / abs(score_cpu)
    check(math.isfinite(score) and score > 0 and rel <= LPIPS_REL,
          f"LPIPS card {score} against CPU {score_cpu}: {rel:.3g} relative")
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        score_global_tf32 = card(pred, gt)
        fp32_flags = L.fp32_convolutions
        L.fp32_convolutions = contextlib.nullcontext
        try:
            score_tf32 = card(pred, gt)
        finally:
            L.fp32_convolutions = fp32_flags
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    check(score_global_tf32 == score,
          f"LPIPS moved with cuDNN's TF32 switch: {score_global_tf32} "
          f"against {score}")
    a = L.to_batch(pred, card.device)
    b = L.to_batch(gt, card.device)
    flops, nbytes = lpips_cost(H, W)
    bound_ms = max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3
    with torch.no_grad():
        pair_ms = (time_ms(lambda: card.model(a, b), LPIPS_REPS)
                   if torch.device(device).type == "cuda" else None)

    estats: dict = {}
    with env_var("ANIMNERF_LPIPS_WEIGHTS", npz):
        sync(device)
        reset_counts()
        t0 = time.perf_counter()
        scores = TL.evaluate(cfg, last, device=device, stats=estats)
        eval_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    check(sorted(scores) == ["lpips", "psnr", "ssim"]
          and math.isfinite(scores["lpips"]) and scores["lpips"] > 0
          and scores["psnr"] == fitted["test_psnr"]
          and scores["ssim"] == fitted["test_ssim"],
          f"evaluate with LPIPS {scores} against the fit phase's "
          f"{fitted['test_psnr']}, {fitted['test_ssim']}")
    if torch.device(device).type == "cuda":
        check(all(launches[k] > 0 for k in SERVE_KERNELS),
              f"evaluate with LPIPS launched: {launches}")
    score_ms = [t * 1e3 for t in estats["score_s"]]
    base_ms = fitted["eval_score_ms"]
    return {
        "npz_equal": same, "convert_ms": convert_ms,
        "pair": "docs/demo/scale512/fit_val.png: render vs ground truth, "
                f"{H}x{W}",
        "score_card": score, "score_cpu": score_cpu, "rel": rel,
        "bound_rel": LPIPS_REL, "score_global_tf32_on": score_global_tf32,
        "score_tf32_convs": score_tf32,
        "rel_tf32_convs": abs(score_tf32 - score_cpu) / abs(score_cpu),
        "pair_ms": pair_ms, "cpu_pair_ms_host": cpu_ms,
        "pair_gflop": flops / 1e9, "pair_mbytes": nbytes / 1e6,
        "bound_ms": bound_ms, "bound_by": "operations"
        if flops / PEAK_F32 >= nbytes / PEAK_BYTES else "bytes",
        "evaluate": scores, "evaluate_s": eval_s,
        "eval_render_ms": [t * 1e3 for t in estats["frame_s"]],
        "eval_score_ms_lpips": score_ms,
        "eval_score_ms_no_lpips": base_ms,
        "eval_frame_ms_lpips": [r + m for r, m in zip(
            (t * 1e3 for t in estats["frame_s"]), score_ms)],
        "eval_frame_ms_no_lpips": [r + m for r, m in zip(
            fitted["eval_frame_ms"], base_ms)],
        "lpips_added_ms": float(np.median(score_ms) - np.median(base_ms)),
        "launches": launches}, npz


# prep_tools: RVM on RVM_FRAMES PNG frames at RVM_SIZE^2 with a warm-up of
# RVM_WARMUP; the VIBE driver on VIBE_FRAMES frames of VIBE_HW with two
# people, one in view for fewer frames than the driver keeps
RVM_FRAMES = 8
RVM_SIZE = 512
RVM_WARMUP = 4
VIBE_FRAMES = 30
VIBE_HW = (480, 640)


def tiny_rvm():
    """A small recurrent matting model with RVM's signature, for
    ``torch.jit.script``. Its arithmetic is exact in float32 on any
    device (integer pixel values, sums of at most 2^24, scalings by
    powers of two, one rounded add and halving a frame for the state), so
    a card run and a CPU run give the same matte bit for bit: the frame
    quantised back to 0..255, a luma-like channel sum, an area pool by
    1 / downsample_ratio, a 3x3 neighbour sum, the state r1 = (r1 + h) / 2,
    r2 counting frames, the matte clamp(r1 / 16384 + 1 / 16) upsampled by
    repetition."""
    import torch
    import torch.nn.functional as F
    from typing import Optional

    class TinyRVM(torch.nn.Module):
        def forward(self, src, r1: Optional[torch.Tensor] = None,
                    r2: Optional[torch.Tensor] = None,
                    r3: Optional[torch.Tensor] = None,
                    r4: Optional[torch.Tensor] = None,
                    downsample_ratio: float = 0.25):
            q = torch.round(src * 255.0)
            g = 2.0 * q[:, 0:1] + 5.0 * q[:, 1:2] + q[:, 2:3]
            k = int(round(1.0 / downsample_ratio))
            low = F.avg_pool2d(g, k)
            p = F.pad(low, (1, 1, 1, 1), mode="replicate")
            hh, ww = low.shape[2], low.shape[3]
            h = torch.zeros_like(low)
            for dy in range(3):
                for dx in range(3):
                    h = h + p[:, :, dy:dy + hh, dx:dx + ww]
            if r1 is None:
                r1 = h
            else:
                r1 = (r1 + h) * 0.5
            if r2 is None:
                r2 = torch.zeros(1, device=src.device)
            r2 = r2 + 1.0
            pha = torch.clamp(r1 * (1.0 / 16384.0) + 0.0625, 0.0, 1.0)
            pha = pha.repeat_interleave(k, dim=2).repeat_interleave(k, dim=3)
            return src, pha, r1, r2, r3, r4

    return torch.jit.script(TinyRVM())


def vibe_frames(d: str, n: int = VIBE_FRAMES, hw=VIBE_HW) -> list:
    """Frames of two walkers as PNGs (person A, red, in every frame;
    person B, blue, in the first 10) and their true boxes."""
    from animnerf_tpu_torch.utils.image import write_png

    os.makedirs(d)
    H, W = hw
    boxes = []
    for f in range(n):
        img = np.full((H, W, 3), 30, np.uint8)
        a = [40 + 6 * f, 100, 200 + 6 * f, 420]
        img[a[1]:a[3], a[0]:a[2]] = (200, 60 + f, 40)
        fb = [a]
        if f < 10:
            b = [500 - 4 * f, 150, 600 - 4 * f, 400]
            img[b[1]:b[3], b[0]:b[2]] = (30, 40, 220)
            fb.append(b)
        write_png(os.path.join(d, f"{f:06d}.png"), img)
        boxes.append(fb)
    return boxes


def vibe_detector(img):
    """The injected person detector: the red and the blue boxes."""
    boxes = []
    for mask in (img[..., 0] > 150, (img[..., 2] > 150) & (img[..., 0] < 100)):
        ys, xs = np.nonzero(mask)
        if len(xs) > 50:
            boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
    return np.asarray(boxes, np.float32).reshape(-1, 4)


def vibe_regressor(device):
    """The injected regressor: a small torch module on ``device`` (a
    strided convolution, a pool and a linear head) mapping (T, S, S, 3)
    crops to cam (3), pose (72) and betas (10), as tensors there."""
    import torch

    torch.manual_seed(LPIPS_SEED)
    conv = torch.nn.Conv2d(3, 16, 8, stride=8).to(device)
    head = torch.nn.Linear(16, 3 + 72 + 10).to(device)

    def model_fn(crops):
        x = torch.from_numpy(crops).to(device).permute(0, 3, 1, 2)
        with torch.no_grad():
            y = head(torch.relu(conv(x)).mean(dim=(2, 3)))
        cam = torch.cat([0.8 + 0.1 * torch.tanh(y[:, :1]), y[:, 1:3]], 1)
        return {"cam": cam, "pose": 0.1 * y[:, 3:75],
                "betas": 0.1 * y[:, 75:]}

    return model_fn


def prep_tools_phase(device: str = "cuda", rvm_size: int = RVM_SIZE,
                     vibe_hw=VIBE_HW) -> dict:
    """The subject-from-video tools on ``device``: ``run_rvm`` with the
    scripted ``tiny_rvm`` saved and loaded back with
    ``torch.jit.load(map_location=device)`` against a CPU run of the same
    file (RGBA PNGs bit-equal, the warm-up frames not written); then
    ``run_vibe_driver`` with ``vibe_detector`` and ``vibe_regressor`` on
    the device, and ``convert_vibe`` on its output (tracklets, keys,
    shapes, orig_cam against numpy's formula in float32)."""
    from animnerf_tpu_torch.smpl.loader import load_pickle
    from animnerf_tpu_torch.tools.convert_vibe import convert
    from animnerf_tpu_torch.tools.rvm import run_rvm
    from animnerf_tpu_torch.tools.vibe_driver import (
        MIN_NUM_FRAMES,
        run_vibe_driver,
    )
    from animnerf_tpu_torch.utils.image import read_png, write_png

    root = tempfile.mkdtemp(prefix="prep_tools_", dir=os.path.join(ROOT,
                                                                   "build"))
    try:
        rng = np.random.default_rng(LPIPS_SEED)
        frames = os.path.join(root, "frames")
        os.makedirs(frames)
        yy, xx = np.mgrid[0:rvm_size, 0:rvm_size]
        for i in range(RVM_FRAMES):
            img = np.stack([(xx + 16 * i) % 256, (yy * 2) % 256,
                            (xx + yy) % 256], -1).astype(np.int64)
            img = img + rng.integers(-20, 21, img.shape)
            write_png(os.path.join(frames, f"{i:06d}.png"),
                      np.clip(img, 0, 255).astype(np.uint8))
        ts = os.path.join(root, "rvm.torchscript")
        tiny_rvm().save(ts)
        out = {}
        ms = {}
        for dev in (device, "cpu"):
            sync(dev)
            t0 = time.perf_counter()
            n = run_rvm(frames, os.path.join(root, f"out_{dev}"),
                        checkpoint=ts, warmup=RVM_WARMUP, device=dev)
            sync(dev)
            ms[dev] = (time.perf_counter() - t0) * 1e3
            names = sorted(os.listdir(os.path.join(root, f"out_{dev}")))
            check(n == RVM_FRAMES and names == sorted(os.listdir(frames)),
                  f"run_rvm on {dev} wrote {n}: {names}")
            out[dev] = [read_png(os.path.join(root, f"out_{dev}", f))
                        for f in names]
        rvm_equal = all(np.array_equal(a, b)
                        for a, b in zip(out[device], out["cpu"]))
        check(rvm_equal, "run_rvm on the card differs from the CPU run")
        rgb_kept = all(np.array_equal(o[..., :3], read_png(
            os.path.join(frames, f"{i:06d}.png")))
            for i, o in enumerate(out[device]))
        alphas = np.stack([o[..., 3] for o in out[device]])
        check(rgb_kept and 0 < alphas.mean() < 255,
              "the RGBA frames lost their pixels or have a flat matte")

        images = os.path.join(root, "subj", "cam000", "images")
        truth = vibe_frames(images, hw=vibe_hw)
        sync(device)
        t0 = time.perf_counter()
        res = run_vibe_driver(images, os.path.join(root, "vibe"),
                              vibe_detector, vibe_regressor(device),
                              batch_size=16)
        sync(device)
        driver_ms = (time.perf_counter() - t0) * 1e3
        check(len(res) == 1, f"tracklets kept: {sorted(res)}")
        tid, track = next(iter(res.items()))
        F_ = len(track["frame_ids"])
        check(F_ == VIBE_FRAMES >= MIN_NUM_FRAMES
              and track["pose"].shape == (F_, 72)
              and track["betas"].shape == (F_, 10)
              and track["pred_cam"].shape == (F_, 3)
              and track["bboxes"].shape == (F_, 4)
              and np.isfinite(track["orig_cam"]).all(),
              f"the tracklet: { {k: np.shape(v) for k, v in track.items()} }")
        a0 = np.asarray(truth[0][0], np.float32)
        check(np.array_equal(track["bboxes"][0], np.array(
            [(a0[0] + a0[2]) / 2, (a0[1] + a0[3]) / 2, a0[2] - a0[0],
             a0[3] - a0[1]], np.float32)), "the tracker's first box")
        cam, bb = track["pred_cam"], track["bboxes"]
        H, W = vibe_hw
        h = np.maximum(bb[:, 2], bb[:, 3])
        sx = cam[:, 0] * (1.0 / (W / h))
        sy = cam[:, 0] * (1.0 / (H / h))
        want_cam = np.stack([
            sx, sy,
            (bb[:, 0] - W / 2.0) / (W / 2.0) / np.maximum(sx, 1e-9)
            + cam[:, 1],
            (bb[:, 1] - H / 2.0) / (H / 2.0) / np.maximum(sy, 1e-9)
            + cam[:, 2]], -1)
        check(np.array_equal(track["orig_cam"], want_cam),
              "orig_cam differs from numpy's formula")

        for f in sorted(os.listdir(images), reverse=True):
            os.rename(os.path.join(images, f), os.path.join(
                images, f"{int(f[:6]) + 1:06d}.png"))
        shutil.copy(os.path.join(root, "vibe", "vibe_output.pkl"),
                    os.path.join(root, "subj", "vibe_output.pkl"))
        t0 = time.perf_counter()
        convert(root, "subj", track_id=tid)
        convert_ms = (time.perf_counter() - t0) * 1e3
        smpls = sorted(os.listdir(os.path.join(root, "subj", "smpls")))
        camera = load_pickle(os.path.join(root, "subj", "cam000",
                                          "camera.pkl"))
        p = load_pickle(os.path.join(root, "subj", "smpls", smpls[0]))
        shapes = {k: list(np.shape(v)) for k, v in p.items()
                  if not isinstance(v, str)}
        check(len(smpls) == F_ and camera["height"] == H
              and camera["width"] == W
              and list(camera["camera_c"]) == [H // 2, W // 2]
              and shapes == {"betas": [10], "global_orient": [3],
                             "body_pose": [69], "transl": [3]}
              and p["transl"].dtype == np.float32
              and np.isfinite(p["transl"]).all(),
              f"convert_vibe: {len(smpls)} pickles, {shapes}")
        return {"rvm_frames": RVM_FRAMES, "rvm_size": rvm_size,
                "rvm_warmup": RVM_WARMUP, "rvm_ms": ms[device],
                "rvm_ms_per_frame": ms[device] / (RVM_FRAMES + RVM_WARMUP),
                "rvm_cpu_ms": ms["cpu"], "rvm_card_equals_cpu": rvm_equal,
                "alpha_mean": float(alphas.mean()),
                "vibe_frames": VIBE_FRAMES, "vibe_hw": list(vibe_hw),
                "vibe_driver_ms": driver_ms, "tracklets": len(res),
                "tracklet_frames": F_, "convert_vibe_ms": convert_ms,
                "smpl_pickles": len(smpls), "pickle_shapes": shapes}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# compact_train: the point-major compacted step (CompactTrainer) at the
# flagship's full width against the dense and rows engines on one batch
# and noise (bf16 field). Not bit-equal: the compacted step's kNN runs on
# the mesh-order cloud, the others' on the Morton order, so the packed
# keys break near-ties by other indices, and the composites sum in other
# layouts; bf16 roundings of the MLP inputs then differ. The H100 run
# measured loss terms 1.9e-5 relative, field gradients 1.0-1.1e-4
# and body-param gradients 4.0e-2 rel-L2 against both (PERF.md;
# card against CPU the body gradients are 2.1-2.3e-2 in bf16): the stated
# bounds are loss terms 1e-4, field gradients 1e-3, body gradients 1e-1
COMPACT_BOUND = dict(loss_rtol=1e-4, grad_rel_l2={
    "field": 1e-3, "fine_field": 1e-3, "body_params": 1e-1})
COMPACT_STEPS = 10
COMPACT_KERNELS = ("knn", "warp_blend", "scatter", "fused_mlp",
                   "fused_mlp_bwd", "fused_mlp_wgrad", "permute_lanes")


def engine_grads(engine: str, batch, noise, dev, make_rig=None) -> tuple:
    """One loss and backward of ``engine``'s loss on a fresh seed-0
    flagship system: (details as floats, gradients by group)."""
    import torch

    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.training.system import ENGINES

    system = AnimNeRFSystem(FLAGSHIP_CFG, (make_rig or smpl_rig)(),
                            device=dev, seed=0)
    loss, d = ENGINES[engine].loss_fn(system, batch, noise)
    loss.backward()
    sync(dev)
    return ({k: float(v.detach()) if torch.is_tensor(v) else float(v)
             for k, v in d.items()}, _grad_groups(system))


def timed_steps(trainer, batches, n: int):
    """A warm-up step, then n timed steps (synchronised) with the launch
    counts set to 0 just before and read just after: (ms, compact counts,
    launches)."""
    from animnerf_tpu_torch.ops import _build

    dev = trainer.system.device
    trainer.step(batches[n])
    sync(dev)
    reset_counts()
    ms, counts = [], []
    for s in range(n):
        t0 = time.perf_counter()
        d = trainer.step(batches[s])
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(d["compact_count"])
        check(finite(trainer, d), f"{trainer.engine} step {s}: non-finite")
    return ms, counts, dict(_build.LAUNCHES)


def compact_train(dev, B: int = 16, R: int = 1024, n: int = COMPACT_STEPS,
                  make_rig=None) -> dict:
    """The flagship step (bench.py's 16 x 1024 rays, V = 6890, 64 + 32
    samples, bf16) through ``make_trainer(engine="compact")``: first its
    loss and gradients on one batch and noise against the dense engine's
    (``loss_fn``: the rows render) and the rows engine's, each within
    COMPACT_BOUND (whether the loss is bit-equal to the dense one is
    reported); then n timed steps (kernels 1-6 launched, no tile skip),
    the survivor share (coarse survivors over a row's R x Kc samples),
    one profiled step split by kernel, and the rows engine's steps and
    profile in the same run."""
    import torch

    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.training.system import make_trainer
    from animnerf_tpu_torch.utils.rng import draw_noise

    batches = train_batches(B, R, range(n + 1), dev)
    system = AnimNeRFSystem(FLAGSHIP_CFG, (make_rig or smpl_rig)(),
                            device=dev, seed=0)
    noise = draw_noise(torch.Generator(device=dev).manual_seed(7), B, R,
                       system.renderer_cfg, system.body_model.num_verts)
    res = {e: engine_grads(e, batches[0], noise, dev, make_rig)
           for e in ("compact", "dense", "rows")}
    dc, gc = res["compact"]
    agree = {}
    bd = COMPACT_BOUND
    for other in ("dense", "rows"):
        do, go = res[other]
        loss_rel = max(abs(dc[k] - do[k]) / max(abs(do[k]), 1e-12)
                       for k in do if k in dc
                       and not k.startswith("compact"))
        grad_rel = {k: float((gc[k] - go[k]).norm()
                             / max(float(go[k].norm()), 1e-30)) for k in go}
        agree[other] = dict(loss=do["loss"], max_loss_term_rel=loss_rel,
                            loss_bit_equal=dc["loss"] == do["loss"],
                            grad_rel_l2=grad_rel, bounds=bd,
                            compact_count=do.get("compact_count"))
        check(loss_rel <= bd["loss_rtol"]
              and all(v <= bd["grad_rel_l2"][k] for k, v in grad_rel.items()),
              f"compact step against {other}: {agree[other]}")
    del res

    out = {"rays_per_step": B * R, "loss": dc["loss"],
           "compact_count": dc["compact_count"], "against": agree}
    Kc = system.renderer_cfg.n_coarse
    for engine in ("compact", "rows"):
        trainer = make_trainer(system, steps_per_epoch=100, engine=engine)
        ms, counts, launches = timed_steps(trainer, batches, n)
        med = float(np.median(ms))
        out[engine] = dict(
            engine=trainer.engine, steps=n, ms=ms, median_step_ms=med,
            train_rays_per_s=B * R / (med / 1e3),
            median_compact_count=float(np.median(counts)),
            survivor_share=float(np.median(counts)) / (R * Kc),
            launches=launches,
            profile=profile_call(lambda: trainer.step(batches[0]), "step",
                                 by_kernel=True)
            if dev == "cuda" else None)
    if dev == "cuda":
        launches = out["compact"]["launches"]
        check(all(launches[k] > 0 for k in COMPACT_KERNELS)
              and launches["knn_tile_skip"] == 0,
              f"the compact step launched the wrong kernels: {launches}")
    return out


# knn_packed_off: one SMPL view (scale512, view 29, 512^2) with
# ANIMNERF_KNN_PACKED=0 against the same view with the packed keys, the
# images within PACKED_OFF_BOUNDS (max |d|, PSNR dB). The packed keys
# quantise d2 to 2^-10 relative, which moves the blended distance of a
# few samples across dis_threshold (a sample then takes the MLP's sigma
# in one view and the outside fill in the other): the H100 run
# measured max |d| 0.0796 on 102 pixels at 68.9 dB (PERF.md)
PACKED_OFF_VIEW = 29
PACKED_OFF_SAMPLE = 1 << 16
PACKED_OFF_BOUNDS = (0.2, 60.0)


def knn_packed_off(ck, bp, tmpl, device: str = "cuda", H: int = 512,
                   W: int = 512) -> dict:
    """The scale512 view with the packed kNN (kernel 1), then with
    ANIMNERF_KNN_PACKED=0, the launch counts set to 0 just before and read
    just after each: kernel 9 launched and kernels 1 and 8 not; the exact
    view's first kNN call's points (its coarse warp), on a seeded sample
    of PACKED_OFF_SAMPLE, through the dispatch (kernel 9) against the
    plain exact version, bit-equal; the two images within
    PACKED_OFF_BOUNDS."""
    import torch

    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.ops.knn_kernel import knn, knn_exact_plain
    from animnerf_tpu_torch.render.inference import (
        Renderer,
        turntable_rotation,
    )

    system = scale512_system(ck, device)
    renderer = Renderer(system, device=device)
    P = turntable_rotation(PACKED_OFF_VIEW, 64)

    def render():
        return renderer.render_frame(bp, tmpl, frame_rays(H, W), P, (W, H))

    def view():
        sync(device)
        reset_counts()
        t0 = time.perf_counter()
        img = render()[0]
        return img, (time.perf_counter() - t0) * 1e3, dict(_build.LAUNCHES)

    view()                                     # warm-up
    img_p, ms_p, launches_p = view()
    os.environ["ANIMNERF_KNN_PACKED"] = "0"
    try:
        view()
        img_e, ms_e, launches_e = view()
        calls = capture_knn(render, keep=True)
        pts, verts, k = calls[0]["points"], calls[0]["verts"], calls[0]["k"]
        sel = torch.from_numpy(np.sort(np.random.default_rng(0).choice(
            pts.shape[1], min(PACKED_OFF_SAMPLE, pts.shape[1]),
            replace=False))).to(pts.device)
        sample = pts[:, sel].contiguous()
        reset_counts()
        d, i = knn(sample, verts, k)
        sample_launches = dict(_build.LAUNCHES)
        dp, ip = knn_exact_plain(sample, verts, k)
        bit_equal = bool(torch.equal(d, dp) and torch.equal(i, ip))
    finally:
        del os.environ["ANIMNERF_KNN_PACKED"]
    if device == "cuda":
        check(launches_e["knn_exact"] > 0 and launches_e["knn"] == 0
              and launches_e["knn_packed"] == 0
              and sample_launches["knn_exact"] == 1,
              f"ANIMNERF_KNN_PACKED=0 view launched: {launches_e}")
        check(launches_p["knn"] > 0 and launches_p["knn_exact"] == 0,
              f"the packed view launched: {launches_p}")
    check(bit_equal, "kernel 9 on the view's points differs from its plain "
          "version")
    diff = dict(image_diff(img_e, img_p), pixels_over_1e_2=int(
        (np.abs(img_e - img_p).max(-1) > 1e-2).sum()))
    check(np.isfinite(img_e).all() and diff["max_abs"] <= PACKED_OFF_BOUNDS[0]
          and diff["psnr_db"] >= PACKED_OFF_BOUNDS[1],
          f"packed-off view against the packed view: {diff}")
    return {"view": PACKED_OFF_VIEW, "size": [W, H],
            "ms_packed": ms_p, "ms_exact": ms_e,
            "launches_packed": launches_p, "launches": launches_e,
            "knn_calls": [[c["N"], c["V"], c["k"]] for c in calls],
            "sample_points": int(sample.shape[1]),
            "sample_bit_equal_plain": bit_equal,
            "exact_vs_packed_image": diff, "bounds": PACKED_OFF_BOUNDS}


# ------------------------------------------------------------------ dist

# the dist phase: data parallelism (``animnerf_tpu_torch/parallel/``) in
# child processes made with the spawn context, a file:// rendezvous in a
# temporary directory; each rank group may take DIST_JOIN_S seconds and
# each collective DIST_COLLECTIVE_S before the run fails
DIST_STEPS = 3
DIST_JOIN_S = 420
DIST_COLLECTIVE_S = 180
DIST_VIEW = 29
DIST_REPS = 20
# two ranks sharing one card: step 1 against the one-process 16 x 1024
# loss. Every term is held to loss_rtol against that loss with its
# cuBLAS calls that depend on the batch size cut at a rank's 8 rows (the
# plain nn.Linear MLP's GEMMs, gemm_rows_split; the body model's,
# frames_per_shard), and bit-equal to the mean of two one-process
# 8 x 1024 loss evaluations on the same rows and noise. Against the
# unchanged one-process step the terms of the hand kernels' render and
# the total are held to loss_rtol; PLAIN_MLP_TERMS, which the plain MLP
# computes in bf16 on cuBLAS, to plain_mlp_loss_rtol: cuBLAS rounds a
# row differently at 8 and at 16 rows
DIST_BOUNDS = dict(loss_rtol=1e-5, plain_mlp_loss_rtol=1e-4,
                   grad_rel_l2=2e-2)
PLAIN_MLP_TERMS = ("loss_foreground", "loss_background", "loss_normals")
DIST_LABEL = "two ranks sharing one H100, not a scaling figure"
# the torchrun fit: steps of the fit phase's dataset
DIST_FIT_STEPS = 4


def _dist_child(rank: int, world: int, backend: str, init: str, out: str,
                task: str) -> None:
    """One spawned rank on card 0: join the group (NCCL or gloo), run
    DIST_TASKS[task], pickle its result."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    extra = {"device_id": torch.device("cuda", 0)} if backend == "nccl" \
        else {}
    dist.init_process_group(
        backend, init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DIST_COLLECTIVE_S), **extra)
    try:
        res = DIST_TASKS[task]()
        torch.cuda.synchronize()
        with open(os.path.join(out, f"{task}-{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def frames_per_shard(parts: int):
    """``training/system.py``'s ``prepare_frame`` evaluated on each of
    ``parts`` equal slices of the batch, the frame contexts concatenated:
    the body model's batched GEMMs see the rows of one of ``parts``
    ranks."""
    import dataclasses

    import torch

    from animnerf_tpu_torch.training import system as TS

    whole = TS.prepare_frame

    def prepare(model, params: dict, tmpl: dict):
        m = next(iter(params.values())).shape[0] // parts
        ctxs = [whole(model, *({k: v[i * m:(i + 1) * m] for k, v in
                                d.items()} for d in (params, tmpl)))
                for i in range(parts)]
        return dataclasses.replace(ctxs[0], **{
            f.name: torch.cat([getattr(c, f.name) for c in ctxs])
            for f in dataclasses.fields(ctxs[0])
            if f.name != "lbs_weights"})

    TS.prepare_frame = prepare
    try:
        yield
    finally:
        TS.prepare_frame = whole


@contextlib.contextmanager
def gemm_rows_split(parts: int):
    """Every ``torch.nn.functional.linear`` on an input of 3 or more axes
    evaluated as ``parts`` calls on equal slices of its leading (batch)
    axis, the backward too: the plain MLP's cuBLAS GEMMs see the rows of
    one of ``parts`` ranks."""
    import torch

    F = torch.nn.functional
    whole = F.linear

    def linear(x, w, b=None):
        if x.dim() >= 3 and x.shape[0] % parts == 0:
            return torch.cat([whole(c, w, b) for c in x.chunk(parts)], 0)
        return whole(x, w, b)

    F.linear = linear
    try:
        yield
    finally:
        F.linear = whole


def smi_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def dist_spawn(task: str, world: int, backend: str, tmp: str) -> list:
    """DIST_TASKS[task] on ``world`` spawned ranks -> each rank's result.
    A rank that raises fails the run; ranks still running after
    DIST_JOIN_S seconds are killed and fail it."""
    import pickle

    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        _dist_child, args=(world, backend,
                           f"file://{os.path.join(tmp, 'rdv-' + task)}",
                           tmp, task),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DIST_JOIN_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            ctx.join(timeout=30)
            raise AssertionError(f"dist {task}: ranks still running after "
                                 f"{DIST_JOIN_S} s")
    res = []
    for r in range(world):
        with open(os.path.join(tmp, f"{task}-{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def host_batches(seeds) -> list:
    """bench.py's 16 x 1024 batches (train_batches) as numpy, the global
    batches the sharded step's place_batch takes."""
    return [{k: v.numpy() for k, v in b.items()}
            for b in train_batches(16, 1024, seeds, "cpu")]


def dist_frame_batch(bp: dict, tmpl: dict, H: int = 512,
                     W: int = 512) -> dict:
    """One H x W evaluation frame of the scale512 body (given params,
    frame_idx -1) as the loop's render_frame takes it."""
    n = H * W
    return {"frame_idx": np.array([-1]), **bp,
            **{k + "_template": v for k, v in tmpl.items()},
            "rays": frame_rays(H, W)[None],
            "rgbs": np.zeros((1, n, 3), np.float32),
            "alphas": np.zeros((1, n, 1), np.float32)}


def _dist_train(system, step, place_batch, host: list) -> dict:
    """The steps on the host batches: each synchronised step's ms, the
    losses, the details, the launch counts (set to 0 just before, read
    just after) and step 1's gradients by group."""
    import torch

    from animnerf_tpu_torch.ops import _build

    torch.cuda.synchronize()
    reset_counts()
    ms, details, grads = [], [], None
    for b in host:
        t0 = time.perf_counter()
        d = step(place_batch(b))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        details.append({k: float(v) for k, v in d.items()})
        if grads is None:
            grads = _grad_groups(system)
    launches = dict(_build.LAUNCHES)
    return {"step_ms": ms, "details": details, "grads": grads,
            "launches": launches,
            "params": {k: v.detach().cpu() for k, v in
                       system.named_parameters()}}


def dist_world1() -> dict:
    """(a) One rank over NCCL: bench.py's step through
    ``make_sharded_trainer`` and through ``RowsCompactTrainer.step``, each
    on a fresh seed-0 system, one warm-up step then DIST_STEPS steps on the
    same host batches (to the device as each path takes them) with the
    trainers' own noise; then ``all_reduce_grads`` alone on the sharded
    trainer's last gradients (CUDA events), which must leave them
    bit-equal."""
    import torch

    from animnerf_tpu_torch.parallel import mesh as PM
    from animnerf_tpu_torch.parallel.train_pjit import make_sharded_trainer
    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.training.system import (
        RowsCompactTrainer,
        make_optimizer,
    )

    mesh = PM.make_mesh()
    check(mesh.size == 1 and mesh.backend == "nccl"
          and mesh.device == torch.device("cuda", 0), f"world 1: {mesh}")
    host = host_batches(range(DIST_STEPS + 1))
    out = {}
    for name in ("mesh", "plain"):
        system = AnimNeRFSystem(FLAGSHIP_CFG, smpl_rig(), device="cuda",
                                seed=0)
        opt, sched = make_optimizer(system, 100)
        if name == "mesh":
            step, place_state, place_batch = make_sharded_trainer(
                system, opt, sched, mesh)
            place_state(system)
        else:
            step = RowsCompactTrainer(system, optimizer=opt,
                                      scheduler=sched).step

            def place_batch(b):
                return PM.to_device(b, mesh.device)
        step(place_batch(host[DIST_STEPS]))  # warm-up
        out[name] = _dist_train(system, step, place_batch, host[:DIST_STEPS])
        if name == "mesh":
            params = [p for g in opt.param_groups for p in g["params"]]
            before = [p.grad.clone() for p in params]
            nbytes = PM.all_reduce_grads(mesh, params)
            ms = time_ms(lambda: PM.all_reduce_grads(mesh, params),
                         DIST_REPS)
            out["all_reduce"] = {
                "bytes": nbytes, "tensors": len(params), "ms": ms,
                "bit_equal": all(torch.equal(a, p.grad)
                                 for a, p in zip(before, params))}
        del system, opt, sched, step
        torch.cuda.empty_cache()
    return out


def dist_world2() -> dict:
    """(b) and (c) on two gloo ranks sharing card 0. (b): bench.py's step
    through ``make_sharded_trainer``, each rank on its 8 x 1024 rows of
    the global 16 x 1024 batches, DIST_STEPS steps (no warm-up). (c): one
    512x512 evaluation frame of the scale512 checkpoint through
    ``make_sharded_eval_step`` (the loop's ``render_frame``, 2 x 32,768-ray
    slabs), a warm-up then a timed frame; view DIST_VIEW through
    ``Renderer(mesh=)``, a warm-up then a timed view."""
    import torch

    from animnerf_tpu_torch.parallel import mesh as PM
    from animnerf_tpu_torch.parallel.train_pjit import (
        make_sharded_eval_step,
        make_sharded_trainer,
    )
    from animnerf_tpu_torch.render.inference import Renderer, turntable_rotation
    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.training import loop as TL
    from animnerf_tpu_torch.training.system import make_optimizer

    mesh = PM.make_mesh(device="cuda")
    check(mesh.size == 2 and mesh.backend == "gloo"
          and mesh.device == torch.device("cuda", 0), f"world 2: {mesh}")
    # the collectives the loop adds to the step's (all_reduce SUM and MAX,
    # broadcast, all_gather), on CUDA tensors over gloo
    PM.barrier(mesh)
    PM.check_visible(mesh, ROOT)
    collectives = {"barrier": True, "check_visible": True,
                   "broadcast_object": PM.broadcast_object(
                       mesh, {"rank": mesh.rank}) == {"rank": 0}}
    system = AnimNeRFSystem(FLAGSHIP_CFG, smpl_rig(), device="cuda", seed=0)
    opt, sched = make_optimizer(system, 100)
    step, place_state, place_batch = make_sharded_trainer(system, opt, sched,
                                                          mesh)
    place_state(system)
    out = {"rank": mesh.rank, "collectives": collectives,
           "train": _dist_train(system, step, place_batch,
                                host_batches(range(DIST_STEPS)))}
    del system, opt, sched, step
    torch.cuda.empty_cache()

    _, sys512, bp, tmpl, _ = scale512("cuda")
    eval_step = make_sharded_eval_step(sys512, mesh)
    batch = dist_frame_batch(bp, tmpl)
    slab = TL.EVAL_SLAB * mesh.size
    TL.render_frame(eval_step, batch, slab)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame = TL.render_frame(eval_step, batch, slab)
    out["eval_ms"] = (time.perf_counter() - t0) * 1e3
    out["eval"] = frame
    renderer = Renderer(sys512, mesh=mesh)
    P = turntable_rotation(DIST_VIEW, 64)
    renderer.render_frame(bp, tmpl, frame_rays(512, 512), P, (512, 512))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["view"] = renderer.render_frame(bp, tmpl, frame_rays(512, 512), P,
                                        (512, 512))
    out["view_ms"] = (time.perf_counter() - t0) * 1e3
    return out


DIST_TASKS = {"world1": dist_world1, "world2": dist_world2}


def dist_phase() -> dict:
    """Data parallelism on the card. The one-process references first, in
    this process: bench.py's rows-compacted step 1 on the whole 16 x 1024
    batch (loss terms, gradients by group) and, on the scale512
    checkpoint, the 512x512 evaluation frame through the loop's
    ``render_frame`` (32,768-ray slabs) and view DIST_VIEW through
    ``Renderer(compact_samples=False, cull_rays=False)``. Then (a) one
    rank over NCCL (``dist_world1``): losses and every parameter bit-equal
    to ``RowsCompactTrainer.step``'s; (b) and (c) two gloo ranks on the one
    card (``dist_world2``): each rank launches kernels 1-6, step 1's loss
    terms within DIST_BOUNDS of the one-process 16 x 1024 loss, with its
    plain-MLP GEMMs at a rank's rows and unchanged (the module's bounds;
    ``psnr``, a mean of the shards' PSNRs, is left out), and bit-equal to
    the mean of the one-process loss on each rank's rows and noise, its
    gradients within
    rel-L2 DIST_BOUNDS, the replicas bit-equal after DIST_STEPS steps; the
    sharded frame and the view bit-equal to the one-process ones."""
    import torch

    from animnerf_tpu_torch.parallel import mesh as PM
    from animnerf_tpu_torch.parallel.train_pjit import make_sharded_eval_step
    from animnerf_tpu_torch.render.inference import Renderer, turntable_rotation
    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.training import loop as TL
    from animnerf_tpu_torch.training import system as TS
    from animnerf_tpu_torch.training.system import (
        RowsCompactTrainer,
        rows_compact_loss_fn,
    )

    smi = smi_line()
    system = AnimNeRFSystem(FLAGSHIP_CFG, smpl_rig(), device="cuda", seed=0)
    trainer = RowsCompactTrainer(system, steps_per_epoch=100)
    batch = PM.to_device(host_batches([0])[0], system.device)
    noise = trainer.draw_noise(batch)
    halves = []
    for h in range(2):  # each rank's rows through the one-process loss
        half = PM.Mesh(None, h, 2, system.device)
        _, d = rows_compact_loss_fn(
            system, {k: PM.shard_rows(half, v) for k, v in batch.items()},
            PM.shard_noise(half, noise))
        halves.append({k: v.detach() for k, v in d.items()
                       if k.startswith("loss")})
    half_mean = {k: float((halves[0][k] + halves[1][k]) / 2)
                 for k in halves[0]}
    # the whole batch with the batch-size-dependent cuBLAS calls at 8 rows
    with torch.no_grad():
        obs, canonical = TS._body_params(system, batch)
        ctx16 = TS.prepare_frame(system.body_model, obs, canonical)
        with frames_per_shard(2):
            ctx8 = TS.prepare_frame(system.body_model, obs, canonical)
        frame_diff = {k: float((getattr(ctx16, k) - getattr(ctx8, k))
                               .abs().max())
                      for k in ("verts", "verts_template", "ober2cano")}
    cut = {}
    for name, body in (("mlp", False), ("mlp_and_body_model", True)):
        with gemm_rows_split(2), (frames_per_shard(2) if body
                                  else contextlib.nullcontext()):
            _, d = rows_compact_loss_fn(system, batch, noise)
        cut[name] = {k: float(v.detach()) for k, v in d.items()
                     if k.startswith("loss")}
    d = trainer.step(batch, noise)
    ref_loss = {k: float(v) for k, v in d.items() if k.startswith("loss")}
    ref_grads = _grad_groups(system)
    del system, trainer, batch, noise, halves, ctx16, ctx8
    _, sys512, bp, tmpl, _ = scale512("cuda")
    ref_frame = TL.render_frame(
        make_sharded_eval_step(sys512, PM.make_mesh(device="cuda")),
        dist_frame_batch(bp, tmpl))
    ref_view = Renderer(sys512, compact_samples=False,
                        cull_rays=False).render_frame(
        bp, tmpl, frame_rays(512, 512), turntable_rotation(DIST_VIEW, 64),
        (512, 512))
    del sys512
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="dist_", dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        (w1,) = dist_spawn("world1", 1, "nccl", tmp)
        w1_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        w2 = dist_spawn("world2", 2, "gloo", tmp)
        w2_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (a)
    m, p = w1["mesh"], w1["plain"]
    same1 = ([x["loss"] for x in m["details"]]
             == [x["loss"] for x in p["details"]]
             and sorted(m["params"]) == sorted(p["params"])
             and all(torch.equal(m["params"][k], v)
                     for k, v in p["params"].items()))
    check(same1 and w1["all_reduce"]["bit_equal"],
          "dist world 1 (NCCL): the sharded step differs from "
          "RowsCompactTrainer.step, or the all-reduce changed a gradient")
    check(all(m["launches"][k] > 0 for k in TRAIN_KERNELS),
          f"dist world 1: a kernel was not launched: {m['launches']}")
    world1 = {"backend": "nccl", "steps": DIST_STEPS, "rays": 16 * 1024,
              "losses": [x["loss"] for x in m["details"]],
              "bit_equal_to_one_process": same1,
              "step_ms_mesh": m["step_ms"], "step_ms_plain": p["step_ms"],
              "median_step_ms_mesh": float(np.median(m["step_ms"])),
              "median_step_ms_plain": float(np.median(p["step_ms"])),
              "all_reduce": w1["all_reduce"], "launches": m["launches"],
              "seconds": w1_s}

    # (b)
    r0, r1 = (w["train"] for w in w2)
    check([w["rank"] for w in w2] == [0, 1]
          and all(all(w["collectives"].values()) for w in w2),
          f"dist world 2: ranks, collectives {[w['collectives'] for w in w2]}")
    for w in (r0, r1):
        check(all(w["launches"][k] > 0 for k in TRAIN_KERNELS),
              f"dist world 2: a kernel was not launched: {w['launches']}")
    def rel(want: dict) -> dict:
        return {k: abs(r0["details"][0][k] - v) / max(abs(v), 1e-12)
                for k, v in want.items()}

    loss_rel = rel(ref_loss)
    cut_rel = {k: rel(v) for k, v in cut.items()}
    split_rel = cut_rel["mlp_and_body_model"]
    plain_mlp = [k for k in loss_rel if k.startswith(PLAIN_MLP_TERMS)]
    terms_ok = (max(split_rel.values()) <= DIST_BOUNDS["loss_rtol"]
                and all(v <= DIST_BOUNDS["plain_mlp_loss_rtol"
                                         if k in plain_mlp else "loss_rtol"]
                        for k, v in loss_rel.items()))
    grad_rel = {k: float((r0["grads"][k] - g).norm()
                         / max(float(g.norm()), 1e-30))
                for k, g in ref_grads.items()}
    halves_equal = all(r0["details"][0][k] == v
                       for k, v in half_mean.items())
    replicas = (r0["details"] == r1["details"]
                and all(torch.equal(v, r1["params"][k])
                        for k, v in r0["params"].items())
                and all(torch.equal(v, r1["grads"][k])
                        for k, v in r0["grads"].items()))
    check(terms_ok and max(grad_rel.values()) <= DIST_BOUNDS["grad_rel_l2"]
          and replicas and halves_equal,
          f"dist world 2: loss terms {loss_rel}, against the cuBLAS "
          f"calls at 8 rows {cut_rel}, gradients {grad_rel}, replicas "
          f"bit-equal "
          f"{replicas}, step 1 {r0['details'][0]} against the half-batch "
          f"mean {half_mean}")
    world2 = {"backend": "gloo", "collectives": [w["collectives"]
                                                 for w in w2], "device":
              "cuda:0 for both ranks", "label": DIST_LABEL,
              "rays_per_rank": 8 * 1024, "steps": DIST_STEPS,
              "step_ms_per_rank": [r0["step_ms"], r1["step_ms"]],
              "launches_per_rank": [r0["launches"], r1["launches"]],
              "losses": [x["loss"] for x in r0["details"]],
              "one_process_step1_loss": ref_loss["loss"],
              "step1_loss_term_rel": loss_rel,
              "step1_loss_term_rel_cublas_at_8_rows": cut_rel,
              "frame_context_16_vs_8_rows_max_abs": frame_diff,
              "plain_mlp_terms": plain_mlp, "step1_grad_rel_l2": grad_rel,
              "step1_bit_equal_to_half_batch_mean": halves_equal,
              "bounds": DIST_BOUNDS, "replicas_bit_equal": replicas,
              "seconds": w2_s}

    # (c)
    ev = {}
    for w in w2:
        same = sorted(w["eval"]) == sorted(ref_frame) and all(
            np.array_equal(w["eval"][k], v) for k, v in ref_frame.items())
        diff = image_diff(w["eval"]["rgbs_fine"][0].reshape(512, 512, 3),
                          ref_frame["rgbs_fine"][0].reshape(512, 512, 3))
        vsame = all(np.array_equal(a, b) for a, b in zip(w["view"],
                                                          ref_view))
        vdiff = image_diff(w["view"][0], ref_view[0])
        ev[w["rank"]] = {"eval_bit_equal": same, "eval_vs_one": diff,
                         "eval_frame_ms": w["eval_ms"],
                         "view_bit_equal": vsame, "view_vs_one": vdiff,
                         "view_ms": w["view_ms"]}
        bound = dict(PARITY_BOUNDS)["bfloat16"]
        check((same or (diff["max_abs"] <= bound[0]
                        and diff["psnr_db"] >= bound[1]))
              and (vsame or (vdiff["max_abs"] <= bound[0]
                             and vdiff["psnr_db"] >= bound[1])),
              f"dist sharded evaluation: {ev}")
    return {"nvidia_smi": smi, "world1_nccl": world1,
            "world2_gloo_one_card": world2,
            "sharded_eval": {"frame": [512, 512], "view": DIST_VIEW,
                             "label": DIST_LABEL, "by_rank": ev}}


def npz_arrays(ckpt: str) -> dict:
    """Every array of a checkpoint's anim_nerf.npz and body_params.npz."""
    out = {}
    for g in ("anim_nerf", "body_params"):
        with np.load(os.path.join(ckpt, f"{g}.npz")) as d:
            out.update({f"{g}:{k}": d[k] for k in d.files})
    return out


def dist_torchrun(root: str) -> dict:
    """``torchrun --standalone --nproc_per_node 1 -m
    animnerf_tpu_torch.cli.train`` (NCCL) on the fit phase's dataset for
    DIST_FIT_STEPS steps, and a one-process ``fit`` of the same steps:
    the two ``last`` checkpoints bit-equal, array by array."""
    from animnerf_tpu_torch.training import loop as TL

    opts = fit_opts(root) + ["train.max_steps", str(DIST_FIT_STEPS),
                             "checkpoints_dir", os.path.join(root, "dist_ck"),
                             "logs_dir", os.path.join(root, "dist_logs")]
    t0 = time.perf_counter()
    # at one rank the group is joined only when ANIMNERF_MULTIHOST asks
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "animnerf_tpu_torch.cli.train",
         *opts, "exp_name", "torchrun"], cwd=ROOT, capture_output=True,
        text=True, timeout=DIST_JOIN_S,
        env=dict(os.environ, ANIMNERF_MULTIHOST="1"))
    run_s = time.perf_counter() - t0
    check(r.returncode == 0, "torchrun cli.train failed:\n"
          + r.stdout[-4000:] + r.stderr[-4000:])
    engine = [ln for ln in r.stdout.splitlines()
              if ln.startswith("trainer engine:")]
    backend = engine[0].rsplit("backend=", 1)[-1].rstrip(")") \
        if len(engine) == 1 else None
    check(backend == "nccl" and "mesh=1dev" in engine[0]
          and "device=cuda" in engine[0],
          f"torchrun cli.train: no NCCL engine line:\n{r.stdout[-2000:]}")
    cfg = fit_config(root, opts + ["exp_name", "one"])
    t0 = time.perf_counter()
    TL.fit(cfg, device="cuda")
    fit_s = time.perf_counter() - t0
    got, want = (npz_arrays(os.path.join(root, "dist_ck", exp, "last"))
                 for exp in ("torchrun", "one"))
    same = sorted(got) == sorted(want) and all(
        np.array_equal(got[k], v) for k, v in want.items())
    check(same, "torchrun cli.train's last differs from one-process fit's")
    return {"nvidia_smi": smi_line(), "steps": DIST_FIT_STEPS,
            "backend": backend, "engine_line": engine[0], "nproc": 1,
            "last_bit_equal": same, "arrays": len(want),
            "torchrun_s": run_s, "one_process_fit_s": fit_s}


def main() -> int:
    import torch

    import animnerf_tpu_torch  # noqa: F401  (fails outside the checkout)
    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.ops.knn_kernel import EXACT_WIDE_ABOVE

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
    msass = mxu_sass(funcs)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "cached": lib.cached, "library": os.path.relpath(lib.path, ROOT),
          "ptxas": ptxas,
          "sweep_sass": {f"K={k} {insert}{' tile_skip' if skip else ''}": v
                         for (k, skip, insert), v in sorted(sass.items())},
          "exact_sass": {f"K={k}": v for k, v in sorted(exact.items())},
          "mxu_sass": msass, "mlp_f32_smem": f32_smem_check(),
          "warp_group_max_k": group_max_k_check()})
    check(all((k, False, "packed") in sass for k in range(1, 17))
          and (4, False, "top4") in sass and (4, True, "top4") in sass,
          f"sweep kernels missing from the SASS: {sorted(sass)}")
    check(sorted(exact) == list(range(1, EXACT_WIDE_ABOVE + 1)),
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
    lines.update(kernel_lines_mlp_bwd_freqs("cuda"))
    for name, line in lines.items():
        if name != "fused_mlp_wgrad":
            emit(dict(phase="kernel", name=name, **line))
    emit({"phase": "kernels_done", "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    for name, line in mlp_f32_edge_lines("cuda").items():
        emit(dict(phase="kernel_edge", name=name, **line))
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

    # ---- ANIMNERF_KNN_PACKED=0: the exact kNN (kernel 9) on an SMPL view
    t0 = time.perf_counter()
    packed_off = knn_packed_off(ck, bp, tmpl)
    emit({"phase": "knn_packed_off", **packed_off,
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

    # ---- the opt-in point-major compacted step against dense and rows
    t0 = time.perf_counter()
    compact = compact_train("cuda")
    emit({"phase": "compact_train", **compact,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    tparity = train_parity("cuda")
    emit({"phase": "train_parity", **tparity,
          "seconds": time.perf_counter() - t0})

    # ---- data parallelism: one rank over NCCL, two ranks on the card
    # over gloo, the sharded evaluation and Renderer(mesh=)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    t0 = time.perf_counter()
    emit({"phase": "dist", **dist_phase(),
          "seconds": time.perf_counter() - t0})

    # kernels 3 and 6 in f32 on the flagship's step and view
    t0 = time.perf_counter()
    f32 = f32_profile("cuda")
    emit({"phase": "f32_profile", **f32,
          "seconds": time.perf_counter() - t0})

    # the MLP backward's other encodings on the training path
    t0 = time.perf_counter()
    fparity = freqs_train_parity()
    emit({"phase": "freqs_train_parity",
          **{f"freqs_xyz_{k}": v for k, v in fparity.items()},
          "seconds": time.perf_counter() - t0})

    # ---- the split path and the reference's other fields: kernel 2 with
    # warp_view, the dense trainer, the split serving and eval routes
    t0 = time.perf_counter()
    vlines = warp_view_lines("cuda")
    lines["warp_blend_view_dir"] = dict(vlines[4], k8=vlines[8])
    emit(dict(phase="kernel", name="warp_blend_view_dir",
              **lines["warp_blend_view_dir"]))
    emit({"phase": "warp_view_lines_done",
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    strain = split_train("cuda")
    for name, st in strain.items():
        emit(dict(phase="split_train", config=name, **st))
    emit({"phase": "split_train_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    # the codes config at 4 encoding frequencies under the usual bounds,
    # and at the reference's 10: there DeRF at random weights has an input
    # gradient of ~1e3, and last-bit differences in a canonical point move
    # its, the codes' and the body params' gradients by tens of percent
    # between any two implementations (the JAX package's own step, jitted
    # against op by op, tests/test_torch_codes_spread.py): those three
    # groups are held to CODES10_MULT times that measured spread, the loss
    # terms and the other groups to the usual bounds (its forward image:
    # split_serve's codes parity, at 10)
    emit({"phase": "split_train_parity",
          "view": train_parity("cuda", VIEW_CFG),
          "codes_freqs4": train_parity("cuda", dict(CODES_CFG,
                                                    freqs_xyz=4)),
          "codes_freqs10": train_parity(
              "cuda", CODES_CFG,
              grad_bounds={dt: {k: CODES10_MULT * v
                                for k, v in CODES10_SPREAD.items()}
                           for dt in ("float32", "bfloat16")}),
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    sserve = split_serve()
    emit({"phase": "split_serve", **sserve,
          "seconds": time.perf_counter() - t0})

    # ---- dataset preparation: the signed-distance template at 64^3
    t0 = time.perf_counter()
    emit({"phase": "prepare_template", **prepare_template_phase(),
          "seconds": time.perf_counter() - t0})

    # ---- the subject-from-video tools: RVM's matting driver, the VIBE
    # driver and its converter
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    t0 = time.perf_counter()
    emit({"phase": "prep_tools", **prep_tools_phase(),
          "seconds": time.perf_counter() - t0})

    # ---- the tracer: no synchronising call outside a wait span on the
    # step or the view, the spans on the profiler's clock, a span's cost
    t0 = time.perf_counter()
    emit({"phase": "trace_syncs", **trace_phase(),
          "seconds": time.perf_counter() - t0})

    # ---- training from a dataset on disk: fit, then evaluate from 'last';
    # then the post-training CLIs on that dataset and 'last', the mesh of
    # the trained scale512 system and the sigma grid card against CPU; a
    # reference checkpoint converted and checked on that dataset
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    fit_root = tempfile.mkdtemp(prefix="fit_smoke_",
                                dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        fitted = fit_phase(fit_root, summary["median_step_ms"],
                           summary["median_compact_count"])
        last = fitted.pop("last")
        emit({"phase": "fit", **fitted, "seconds": time.perf_counter() - t0})
        fit_launches = fitted["launches"]

        t0 = time.perf_counter()
        emit({"phase": "dist_torchrun", **dist_torchrun(fit_root),
              "seconds": time.perf_counter() - t0})

        t0 = time.perf_counter()
        cli = cli_phase(fit_root, last)
        cli_launches = cli.pop("cli_launches")
        for entry, line in cli.items():
            emit({"phase": "cli", "entry": entry, **line})
        emit({"phase": "cli_done", "launches": cli_launches,
              "seconds": time.perf_counter() - t0})

        t0 = time.perf_counter()
        mesh, body = mesh_scale512(fit_root)
        emit({"phase": "mesh_scale512", **mesh,
              "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        emit({"phase": "cli_parity", **cli_parity(*body),
              "seconds": time.perf_counter() - t0})
        del body

        t0 = time.perf_counter()
        emit({"phase": "split_fit", **split_fit(fit_root),
              "seconds": time.perf_counter() - t0})

        t0 = time.perf_counter()
        lp, lpips_npz = lpips_phase(fit_config(fit_root), last, fitted)
        emit({"phase": "lpips", **lp, "seconds": time.perf_counter() - t0})

        t0 = time.perf_counter()
        emit({"phase": "convert_parity",
              **convert_parity(fit_root, last, lpips_npz),
              "seconds": time.perf_counter() - t0})
    finally:
        shutil.rmtree(fit_root, ignore_errors=True)

    # ---- SMPL-X: the exact kNN and the min-distance pre-pass
    t0 = time.perf_counter()
    xlines = kernel_lines_smplx("cuda", exact)
    for name, line in xlines.items():
        emit(dict(phase="kernel", name=name, **line))
    lines.update(xlines)
    for name, line in kernel_lines_edge_exact("cuda", exact).items():
        emit(dict(phase="kernel_edge", name=name, **line))
    emit({"phase": "edge_exact_done", "seconds": time.perf_counter() - t0})

    # ---- kernels 8, 9, 2 and 5 above 16 neighbours
    t0 = time.perf_counter()
    wlines = kernel_lines_wide_k("cuda", exact)
    for name, line in wlines.items():
        emit(dict(phase="kernel", name=name, **line))
    lines.update(wlines)
    emit({"phase": "wide_k_lines_done", "seconds": time.perf_counter() - t0})

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

    # ---- k_neigh 24 and 40: the main paths through the wide kNN,
    # warp-blend and scatter, card against CPU
    t0 = time.perf_counter()
    wide = wide_k_phases(ck, bp, tmpl)
    k40prof = wide_k_profile(ck, bp, tmpl, 40)
    check(all(k40prof[p]["launches"][n] > 0
              and k40prof[p]["launches"]["warp_blend_group"]
              == k40prof[p]["launches"]["warp_blend"] > 0
              for p, n in (("step", "knn_packed_wide"),
                           ("view", "knn_packed_wide"),
                           ("smplx_view", "knn_exact_wide"))),
          f"k_neigh 40 paths: {k40prof}")
    emit({"phase": "k40_profile", **k40prof})
    emit({"phase": "k40_view_calls", **k40_view_calls(ck, bp, tmpl)})
    for name, res in wide.items():
        emit({"phase": name, **res})
    emit({"phase": "warp_routes", **warp_routes(ck, bp, tmpl)})
    emit({"phase": "wide_k_done", "seconds": time.perf_counter() - t0})

    # ---- kernel 10 and the port's kNN tool
    t0 = time.perf_counter()
    mlines = kernel_lines_mxu("cuda", msass)
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
        # kernels 3 and 6 in f32: the f32_profile step's and view's
        fused_mlp_f32=f32["step"]["launches"]["fused_mlp"]
        + f32["view"]["launches"]["fused_mlp"],
        fused_mlp_bwd_f32=f32["step"]["launches"]["fused_mlp_bwd"],
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
        knn_tile_skip_far2=ftrain["launches"]["knn_tile_skip"],
        # warp_view: the dense view training steps'
        warp_blend_view_dir=strain["view"]["launches"][
            "warp_blend_view_dir"])
    # the MLP backward at n_freqs 4 and 16: the training steps at those
    # frequencies (bf16: its weight-gradient pass's launches; f32: its f32
    # launches); kernels 8, 2, 5 and 9 at K = 24 and 40: the k_neigh 24 and 40
    # steps and views
    for nf in MLP_BWD_FREQS:
        fl = fparity[nf]["launches"]
        row_launches[f"fused_mlp_bwd_n{nf}"] = fl["fused_mlp_wgrad"]
        row_launches[f"fused_mlp_bwd_f32_n{nf}"] = fl["fused_mlp_bwd_f32"]
    for k in (24, 40):
        paths = [v["launches"] for n, v in wide.items()
                 if n.startswith(f"k{k}_")]
        for kernel in ("knn_packed", "warp_blend", "scatter", "knn_exact"):
            row_launches[f"{kernel}_k{k}"] = sum(p[kernel] for p in paths)
    # the compact step's launches (its timed steps) of kernels 1-6
    compact_launches = compact["compact"]["launches"]
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
                     **({"library_call": ln["library_call"]}
                        if "library_call" in ln else {}),
                     **({"fit_launches": fit_launches[name]}
                        if name in fit_launches else {}),
                     **({"cli_launches": cli_launches[name]}
                        if name in cli_launches else {}),
                     **({"compact_launches": compact_launches[name]}
                        if name in compact_launches else {}),
                     **({"packed_off_launches": packed_off["launches"][name]}
                        if name == "knn_exact" else {}),
                     **({"serve_launches": sserve["view"]["launches"][name]}
                        if name == "warp_blend_view_dir" else {}),
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
