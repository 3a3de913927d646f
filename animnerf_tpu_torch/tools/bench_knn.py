"""Micro-benchmark of the port's kNN kernels on the kNN tool's shapes.

The counterpart of ``tools/bench_knn.py``: 16 x 65536 ray-like query
points against a body-like cloud of V=6890 vertices, k=4, drawn from numpy
seed 0 exactly as that tool draws them. One row per variant:

- exact kNN (kernel 9, ``knn_exact`` without its cull, as the JAX tool's
  row),
- min distance (kernel 7, ``min_vertex_distance``),
- packed extract-min (kernel 8, ``knn_packed`` at k=4),
- packed tournament (kernel 1, ``knn_top4``),
- matmul form at "highest" and "default" precision (kernel 10,
  ``knn_mxu``),

then the tool's correctness lines on 2 x 4096 of the points: packed vs
exact (distance error, index mismatches), tournament vs extract-min
(bit-equal), matmul form vs exact.

Every timed call takes a point set it has not seen (10 sets: 2 warm-up
calls, then ``reps`` timed ones). On a GPU each call is timed with CUDA
events (device time, ``ms``); ``--device cpu`` runs the plain versions at
a size you pick and reports host time (``host_ms``), which is not a device
figure.

Usage: python -m animnerf_tpu_torch.tools.bench_knn [--device cuda|cpu]
       [--batch 16] [--points 65536] [--reps 8]
Prints one JSON object per line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

N_SETS = 10  # distinct point sets: 2 warm-up + up to 8 timed calls


def make_inputs(B: int, N: int, V: int = 6890, seed: int = 0):
    """(verts (B, V, 3), [points (B, N, 3)] * N_SETS) float32 numpy, the
    JAX tool's draws: a normal body-like cloud, ray-like points from
    origins around (0, 0, 3) towards the body."""
    rng = np.random.default_rng(seed)
    verts = rng.normal(scale=0.3, size=(B, V, 3)).astype(np.float32)
    sets = []
    for _ in range(N_SETS):
        o = rng.normal(scale=0.1, size=(B, N, 3)).astype(np.float32)
        o[..., 2] += 3.0
        t = rng.uniform(2.0, 4.0, size=(B, N, 1)).astype(np.float32)
        d = -o / np.linalg.norm(o, axis=-1, keepdims=True)
        sets.append((o + t * d).astype(np.float32))
    return verts, sets


def _time(fn, pts_list, verts, reps: int, cuda: bool):
    """Median and mean per call over ``reps`` calls, each on a new set."""
    for p in pts_list[:2]:
        fn(p, verts)
    times = []
    for p in pts_list[2:2 + reps]:
        if cuda:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn(p, verts)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn(p, verts)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), float(np.mean(times))


def run(device: str = "cuda", B: int = 16, N: int = 65536, reps: int = 8):
    """The benchmark's rows and checks, as a list of dicts."""
    from animnerf_tpu_torch.ops.knn import min_vertex_distance
    from animnerf_tpu_torch.ops.knn_kernel import (
        knn_exact,
        knn_packed,
        knn_top4,
    )
    from animnerf_tpu_torch.ops.knn_mxu import knn_mxu

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("bench_knn: no CUDA device (pass --device cpu "
                           "to run the plain versions)")
    if not 1 <= reps <= N_SETS - 2:
        raise ValueError(f"reps must be in 1..{N_SETS - 2}")
    verts_np, sets = make_inputs(B, N)
    verts = torch.from_numpy(verts_np).to(dev)
    pts_list = [torch.from_numpy(p).to(dev) for p in sets]
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    variants = [
        # as the JAX tool's knn_pallas default: no cull
        ("exact kNN", 9, lambda p, v: knn_exact(p, v, 4, cull=False)),
        ("min distance", 7, min_vertex_distance),
        ("packed extract-min", 8, lambda p, v: knn_packed(p, v, 4)),
        ("packed tournament", 1, knn_top4),
        ("mxu highest", 10, lambda p, v: knn_mxu(p, v, 4, "highest")),
        ("mxu default", 10, lambda p, v: knn_mxu(p, v, 4, "default")),
    ]
    out = []
    for row, kernel, fn in variants:
        med, mean = _time(fn, pts_list, verts, reps, cuda)
        key = "ms" if cuda else "host_ms"
        out.append({"row": row, "kernel": kernel, key: med,
                    f"mean_{key}": mean, "calls": reps,
                    "shape": f"points ({B},{N},3) verts {tuple(verts.shape)}",
                    "device": name})

    pts = pts_list[0][:2, :4096].contiguous()
    v2 = verts[:2].contiguous()
    d_ref, i_ref = knn_exact(pts, v2, 4)
    d_new, i_new = knn_packed(pts, v2, 4)
    rel = (d_ref - d_new).abs() / (d_ref + 1e-12)
    out.append({"check": "packed vs exact",
                "max_rel_d_err": float(rel.max()),
                "idx_mismatch": int((i_ref != i_new).sum()),
                "of": i_ref.numel()})
    d_t, i_t = knn_top4(pts, v2)
    out.append({"check": "tournament vs extract-min bit-equal",
                "d": bool(torch.equal(d_t, d_new)),
                "i": bool(torch.equal(i_t, i_new))})
    for prec in ("highest", "default"):
        d_m, i_m = knn_mxu(pts, v2, 4, prec)
        d_m, i_m = d_m.transpose(1, 2), i_m.transpose(1, 2)
        out.append({"check": f"mxu {prec} vs exact",
                    "max_abs_d_err": float((d_ref - d_m).abs().max()),
                    "idx_mismatch": int((i_ref != i_m).sum()),
                    "of": i_ref.numel()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=8)
    a = ap.parse_args(argv)
    for line in run(a.device, a.batch, a.points, a.reps):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
