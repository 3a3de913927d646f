"""Kernels 8 and 9 above 16 neighbours, kernel 2 at wide K and kernel 10
on several checkouts of the port, on one GPU.

    python3 animnerf_tpu_torch/tools/ab_wide_knn.py ROOT_A ROOT_B [ROOT ...]

Each root runs in a fresh process on its own package and kernel build,
measured by the functions of this checkout's ``chip_smoke.py`` (the same
code for every root, so two checkouts are measured alike): kernel 8 at K
= 40 on 2^20 points around the posed seed-0 SMPL rig and kernel 9 at K =
40 on 2^18 points around the SMPL-X rig (``kernel_lines_wide_k``'s
clouds, random order; each output checked against its plain version,
CUDA-event medians); kernel 2 at K = 24 and 40 on the packed kNN's
neighbours of the SMPL cloud (within 1e-4 of its plain version); kernel
10 in both precisions on the kNN tool's 16 x 65536 x 6890 (the sorted
squared distances within eps = 2^-19 (|p| + max |v|)^2 of its plain
version's, as ``ops/knn_mxu.py`` states); then ``wide_k_profile`` at
k_neigh 40 (the bench.py step, a scale512 view and an SMPL-X view at
512x512, each with its profiled device-busy time, the kNN's share and
the warp-blend's ms). Give the roots as parent, change, change, parent to
see the drift over the call. Prints one JSON line a measurement, tagged
with its root and run, then one summary line.
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
WARP_KS = (24, 40)  # kernel 2's lines


def knn_lines(cs) -> dict:
    """Kernels 8 and 9 at K on kernel_lines_wide_k's clouds, kernel 2 at
    WARP_KS on the SMPL cloud's packed neighbours."""
    import torch

    from animnerf_tpu_torch.models.warp import prepare_frame
    from animnerf_tpu_torch.ops.knn_kernel import (
        knn_exact,
        knn_exact_plain,
        knn_packed,
        knn_packed_plain,
    )
    from animnerf_tpu_torch.ops.warp_blend import (
        warp_blend_fwd,
        warp_blend_fwd_plain,
    )

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(24)
    verts, pts, rows, table, J = cs.smpl_wide_cloud(dev, g)
    with torch.no_grad():
        xctx = prepare_frame(cs.smplx_rig().to(dev),
                             cs.tensors(cs.smplx_params(1, 1), dev),
                             cs.tensors(cs.smplx_params(1, 2,
                                                        zero_transl=True),
                                        dev))
    xverts = xctx.verts_morton.contiguous()
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
    for k in WARP_KS:
        d, i = knn_packed(pts, verts, k)
        args = (rows, d, i, table, J, 0.1, 0.9)
        got, want = warp_blend_fwd(*args), warp_blend_fwd_plain(*args)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        cs.check(err <= 1e-4, f"warp_blend K={k}: max err {err}")
        out[f"warp_blend_k{k}"] = {
            "shape": f"knn {tuple(i.shape)} table {tuple(table.shape)}",
            "max_abs_err": err,
            "ms": cs.time_ms(lambda: warp_blend_fwd(*args), 10)}
        del d, i, got, want
    return out


def mxu_lines(cs) -> dict:
    """Kernel 10 in both precisions on the kNN tool's inputs, its sorted
    squared distances within eps of its plain version's."""
    import torch

    from animnerf_tpu_torch.ops.knn_mxu import knn_mxu, knn_mxu_plain
    from animnerf_tpu_torch.tools.bench_knn import make_inputs

    verts, sets = make_inputs(16, 65536)
    verts = torch.from_numpy(verts).to("cuda")
    pts = torch.from_numpy(sets[0]).to("cuda")
    c = verts.double().mean(dim=1, keepdim=True)
    rv = (verts.double() - c).norm(dim=-1).amax(dim=1, keepdim=True)
    eps = 2.0 ** -19 * ((pts.double() - c).norm(dim=-1) + rv) ** 2
    out = {}
    for prec, name in (("highest", "knn_mxu"), ("default", "knn_mxu_default")):
        d = knn_mxu(pts, verts, 4, prec)[0].double() ** 2
        dp = knn_mxu_plain(pts, verts, 4, prec,
                           max_elems=cs.PLAIN_MAX_ELEMS)[0].double() ** 2
        dev = float(((d - dp).abs() / eps[..., None]).max())
        cs.check(dev <= 1.0, f"{name}: d2 {dev} eps from its plain version")
        out[name] = {"max_d2_dev_over_eps": dev,
                     "ms": cs.time_ms(lambda: knn_mxu(pts, verts, 4, prec),
                                      10)}
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
    emit("mxu_lines", mxu_lines(cs))
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
            **{f"warp_blend_k{k}_ms": by["knn_lines"][f"warp_blend_k{k}"][
                "ms"] for k in WARP_KS},
            **{f"{n}_ms": by["mxu_lines"][n]["ms"]
               for n in ("knn_mxu", "knn_mxu_default")},
            **{f"{p}_{key}": prof[p][src] if src == "median_ms"
               else prof[p]["profile"][src]
               for p in ("step", "view", "smplx_view")
               for key, src in (("median_ms", "median_ms"),
                                ("busy_ms", "device_busy_ms"),
                                ("knn_ms", "knn_ms"),
                                ("knn_share", "knn_share_of_busy"),
                                ("warp_blend_ms", "warp_blend_ms"))}})
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
