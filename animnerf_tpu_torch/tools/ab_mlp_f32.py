"""Kernels 3 and 6 in float32 on several checkouts of the port, on one GPU.

    python3 animnerf_tpu_torch/tools/ab_mlp_f32.py ROOT_A ROOT_B [ROOT ...]

Each root runs in a fresh process on its own package and kernel build,
measured by the functions of this checkout's ``chip_smoke.py`` (the same
code for every root, so two checkouts are measured alike): kernel 3's f32
line (``mlp_f32_line``: the scale512 weights on rows (1, 8, 2^21) and
2^16, beside the plain version and the f32 ``library_mlp_fwd``), kernel
6's f32 lines at n_freqs 10, 4 and 16 (``mlp_bwd_line``: 2^16 points,
checked against the plain version, with the profiled call's device time
by kernel), and the ``f32_profile`` phase (a ``compute_dtype: float32``
step and 512x512 view). A checkout from before the f32 kernels read a
weight image (no ``kernel_image``) gets none in float32. Give the roots
as parent, change, change, parent to see the drift over the call. Prints
one JSON line a measurement, tagged with its root and run, then one
summary line.
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


def run_one(root: str, run: int) -> None:
    """Every measurement of the checkout at root, in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import animnerf_tpu_torch.ops.fused_mlp as fm

    if not hasattr(fm, "kernel_image"):
        fm.kernel_image = (lambda ws: fm.weight_image(ws)
                           if ws[0].dtype == torch.bfloat16 else None)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(MEASURE_ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    def emit(name, obj):
        cs.emit({"root": root, "run": run, "name": name, **obj})

    _, system, _, _, ctx = cs.scale512("cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    M = cs.MLP_F32_POINTS[0]
    tv = ctx.verts_template[0]
    pick = torch.randint(0, tv.shape[0], (M,), generator=g, device="cuda")
    xyz = tv[pick] + 0.05 * torch.randn(M, 3, generator=g, device="cuda")
    xrows = torch.nn.functional.pad(xyz.t(), (0, 0, 0, 5))[None].contiguous()
    emit("fused_mlp_f32", cs.mlp_f32_line(system.scene.nerf_fine, xrows, 20,
                                          3))
    del system, ctx, xrows, xyz, pick
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(1)
    for nf in (10, 4, 16):
        emit(f"fused_mlp_bwd_f32_n{nf}",
             cs.mlp_bwd_line("cuda", g, nf, "float32", 20, 3, profile=True))
    emit("f32_profile", cs.f32_profile("cuda"))


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
        prof = by["f32_profile"]
        summary.append({
            "root": os.path.abspath(root), "run": run,
            "seconds": time.perf_counter() - t0,
            "fwd_ms": by["fused_mlp_f32"]["ms"],
            "fwd_2p16_ms": by["fused_mlp_f32"]["points_2p16"]["ms"],
            **{f"bwd_n{nf}_ms": by[f"fused_mlp_bwd_f32_n{nf}"]["ms"]
               for nf in (10, 4, 16)},
            "step_median_ms": prof["step"]["median_ms"],
            "step_busy_ms": prof["step"]["profile"]["device_busy_ms"],
            "view_median_ms": prof["view"]["median_ms"],
            "view_busy_ms": prof["view"]["profile"]["device_busy_ms"]})
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
