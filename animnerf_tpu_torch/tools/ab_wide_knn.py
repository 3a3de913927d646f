"""Kernels 8 and 9 above 16 neighbours on several checkouts of the port, on
one GPU.

    python3 animnerf_tpu_torch/tools/ab_wide_knn.py ROOT_A ROOT_B [ROOT ...]

Each root runs in a fresh process on its own package and kernel build,
measured by the functions of this checkout's ``chip_smoke.py`` (the same
code for every root, so two checkouts are measured alike): kernel 8 at K
= 40 on 2^20 points around the posed seed-0 SMPL rig and kernel 9 at K =
40 on 2^18 points around the SMPL-X rig (``kernel_lines_wide_k``'s
clouds, random order; each output checked against its plain version,
CUDA-event medians), then ``wide_k_profile`` at k_neigh 40 (the bench.py
step, a scale512 view and an SMPL-X view at 512x512, each with its
profiled device-busy time and the kNN's share). Give the roots as parent,
change, change, parent to see the drift over the call. Prints one JSON
line a measurement, tagged with its root and run, then one summary line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MEASURE_ROOT = os.path.dirname(os.path.dirname(HERE))
K = 40


def knn_lines(cs) -> dict:
    """Kernels 8 and 9 at K on kernel_lines_wide_k's clouds."""
    import numpy as np
    import torch

    from animnerf_tpu_torch.data.synthetic import random_pose_params
    from animnerf_tpu_torch.models.warp import prepare_frame
    from animnerf_tpu_torch.ops.knn_kernel import (
        knn_exact,
        knn_exact_plain,
        knn_packed,
        knn_packed_plain,
    )

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(24)
    pose = random_pose_params(24, batch=1, seed=4)
    tmpl = random_pose_params(24, batch=1, seed=2)
    tmpl["transl"] = np.zeros_like(tmpl["transl"])
    with torch.no_grad():
        ctx = prepare_frame(cs.smpl_rig().to(dev), cs.tensors(pose, dev),
                            cs.tensors(tmpl, dev))
        xctx = prepare_frame(cs.smplx_rig().to(dev),
                             cs.tensors(cs.smplx_params(1, 1), dev),
                             cs.tensors(cs.smplx_params(1, 2,
                                                        zero_transl=True),
                                        dev))
    verts = ctx.verts_morton.contiguous()
    xverts = xctx.verts_morton.contiguous()
    N = 1 << 20
    pick = torch.randint(0, verts.shape[1], (N,), generator=g, device=dev)
    pts = (verts[0, pick] + 0.05 * torch.randn(N, 3, generator=g,
                                               device=dev))[None]
    XN = cs.WIDE_EXACT_POINTS
    xpick = torch.randint(0, xverts.shape[1], (XN,), generator=g,
                          device=dev)
    xpts = (xverts[0, xpick] + 0.1 * torch.randn(
        XN, 3, generator=g, device=dev))[None].contiguous()
    out = {}
    for name, fn, plain, p, v in (
            ("knn_packed", knn_packed,
             lambda: knn_packed_plain(pts, verts, K, cs.PLAIN_MAX_ELEMS),
             pts, verts),
            ("knn_exact", knn_exact,
             lambda: knn_exact_plain(xpts, xverts, K,
                                     max_elems=cs.PLAIN_EXACT_MAX_ELEMS),
             xpts, xverts)):
        got, want = fn(p, v, K), plain()
        torch.cuda.synchronize()
        cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                 f"{name} K={K}: differs from its plain version")
        out[name] = {"shape": f"points {tuple(p.shape)} verts "
                              f"{tuple(v.shape)} K={K}",
                     "ms": cs.time_ms(lambda: fn(p, v, K), 10)}
    return out


def run_one(root: str, run: int) -> None:
    """Every measurement of the checkout at root, in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(MEASURE_ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    def emit(name, obj):
        cs.emit({"root": root, "run": run, "name": name, **obj})

    emit("knn_lines", knn_lines(cs))
    ck, _, bp, tmpl, _ = cs.scale512("cuda")
    emit("k40_profile", cs.wide_k_profile(ck, bp, tmpl, K))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--run", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        run_one(args.one, args.run)
        return 0
    summary = []
    for run, root in enumerate(args.roots):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root, "--run", str(run), root],
                             capture_output=True, text=True)
        lines = [json.loads(ln) for ln in out.stdout.splitlines()
                 if ln.startswith("{")]
        for ln in lines:
            print(json.dumps(ln), flush=True)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        by = {ln["name"]: ln for ln in lines}
        prof = by["k40_profile"]
        summary.append({
            "root": os.path.abspath(root), "run": run,
            "seconds": time.perf_counter() - t0,
            **{f"{n}_k{K}_ms": by["knn_lines"][n]["ms"]
               for n in ("knn_packed", "knn_exact")},
            **{f"{p}_{key}": prof[p][src] if src == "median_ms"
               else prof[p]["profile"][src]
               for p in ("step", "view", "smplx_view")
               for key, src in (("median_ms", "median_ms"),
                                ("busy_ms", "device_busy_ms"),
                                ("knn_ms", "knn_ms"),
                                ("knn_share", "knn_share_of_busy"))}})
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
