"""Host-clock A/B of the SMPL serving view and training step between two
checkouts of the port, on one GPU.

    python3 animnerf_tpu_torch/tools/ab_host_clock.py ROOT_A ROOT_B

Each run is a fresh process in one checkout, on that checkout's own
``chip_smoke.py``, package and kernel build: the 512x512 turntable views
of its serving phase (``render_turntable`` on the scale512 checkpoint) and
its flagship training step (``train_phase``), each with the profiled
view's or step's device-busy time and kNN time (the step's also its MLP
backward's main and other kernels' time and launches, where that
checkout's profile reports them) beside the host-clock median. The runs go A, B, B, A, so that drift over the call shows as the
difference between the two runs of one checkout. Prints one JSON line a
run, then one summary line of the medians per checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ANGLES = [3, 11, 17, 23, 29, 35, 41, 47, 55]


def run_one(root: str) -> dict:
    """The views and steps of the checkout at root, in this process."""
    import numpy as np

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    _, system, bp, tmpl, _ = cs.scale512("cuda")
    views, _, vprof, _ = cs.render_turntable(system, bp, tmpl, ANGLES)
    del system
    steps, summary, sprof, _ = cs.train_phase(
        "cuda", absent=("knn_exact", "min_dist", "knn_packed"))
    view_ms = [v["ms"] for v in views]
    step_ms = [s["ms"] for s in steps]
    return {"root": root, "view_ms": view_ms,
            "median_view_ms": float(np.median(view_ms)),
            "view_busy_ms": vprof["device_busy_ms"],
            "view_idle_share": vprof["idle_share"],
            "view_knn_ms": vprof.get("knn_ms"),
            "step_ms": step_ms,
            "median_step_ms": summary["median_step_ms"],
            "step_busy_ms": sprof["device_busy_ms"],
            "step_idle_share": sprof["idle_share"],
            "step_knn_ms": sprof.get("knn_ms"),
            "step_bwd_main_ms": sprof.get("mlp_bwd_main_ms"),
            "step_bwd_rest_ms": sprof.get("mlp_bwd_wgrad_ms"),
            "step_bwd_launches": sprof.get("mlp_bwd_launches")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", help="ROOT_A ROOT_B")
    ap.add_argument("--run", help="run one checkout in this process")
    args = ap.parse_args()
    if args.run:
        print(json.dumps(run_one(args.run)), flush=True)
        return 0
    if len(args.roots) != 2:
        ap.error("needs ROOT_A and ROOT_B")
    a, b = (os.path.abspath(r) for r in args.roots)
    results = []
    for root in (a, b, b, a):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--run", root], cwd=root, capture_output=True,
                           text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        results.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    summary = {}
    for root in (a, b):
        runs = [x for x in results if x["root"] == root]
        summary[os.path.basename(root)] = {
            key: [x[key] for x in runs]
            for key in ("median_view_ms", "view_busy_ms", "view_idle_share",
                        "view_knn_ms", "median_step_ms", "step_busy_ms",
                        "step_idle_share", "step_knn_ms", "step_bwd_main_ms",
                        "step_bwd_rest_ms", "step_bwd_launches")}
    print(json.dumps({"ab_host_clock": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
