"""The weighted scatter (kernel 5) and the warp-blend (kernel 2) on the
inputs the main paths give them, for one or more checkouts of the port, on
one GPU.

    python3 animnerf_tpu_torch/tools/ab_scatter_warp.py ROOT [ROOT ...]

Each root runs in a fresh process on its own package and kernel build;
the capture and timing helpers are those of this checkout's
``chip_smoke.py`` (``capture_scatter``, ``scatter_call_line``,
``capture_warp_blend``, ``warp_blend_call_line``), which use only the
wrappers' public names. Per root:
- the scatter calls (coarse, fine) of one SMPL training step and of one
  ``k_neigh`` 8 step (the bench.py step), and chip_smoke.py's scatter
  line's uniform indices (every entry live), each with its row statistics,
  its time, its kernels' device time by name and the library times; where
  the root's scatter still sorts with ``torch.sort`` (``sort_entries``),
  also the eager key build, the sort and the kernel timed apart;
- the first warp-blend call of a 512x512 SMPL view, an SMPL-X view
  (``prepass="exact"``, F = 71) and a ``k_neigh`` 8 view, each timed;
- one profiled step and view each, with the scatter's and the
  warp-blend's device time.
Prints one JSON line per measurement, tagged with the root. Give two roots
as A B B A to compare within one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OWN_SMOKE = os.path.join(HERE, "..", "..", "chip_smoke.py")


def emit(root: str, obj: dict) -> None:
    print(json.dumps(dict(root=root, **obj)), flush=True)


def sorted_scatter_parts(c: dict, cs) -> dict:
    """The sort-based scatter's three parts timed apart (CUDA events):
    the eager key build of ``sort_entries``, ``torch.sort`` and the row
    kernel on the sorted keys. Empty where the root's scatter does not
    sort (its C entry no longer takes sorted keys)."""
    import torch

    from animnerf_tpu_torch.ops import _build, blend

    if len(_build.SIGNATURES.get("animnerf_weighted_scatter", ())) != 10:
        return {}
    idx, w, g, V = c["idx"], c["w"], c["g"], c["num_rows"]
    B, K, N = idx.shape

    def keys_only():
        keys = idx + (torch.arange(B, dtype=torch.int32, device=idx.device)
                      * V)[:, None, None]
        live = (w != 0) & (g != 0).any(1, keepdim=True)
        return torch.where(live, keys, B * V).reshape(-1)

    keys = keys_only()
    sk, perm = torch.sort(keys, stable=True)
    out = torch.empty((B, V, 16), device=idx.device)
    lib = _build.kernel_library()
    stream = _build.stream_of(idx)

    def kernel():
        lib.call("animnerf_weighted_scatter", sk.data_ptr(), perm.data_ptr(),
                 w.data_ptr(), g.data_ptr(), out.data_ptr(), B, N, V, K,
                 stream)

    check = blend.weighted_scatter_rows(idx, w, g, V)
    kernel()
    torch.cuda.synchronize()
    cs.check(torch.equal(out, check), "the parts differ from the wrapper")
    return {"key_build_ms": cs.time_ms(keys_only, 20),
            "sort_ms": cs.time_ms(lambda: torch.sort(keys, stable=True), 20),
            "kernel_ms": cs.time_ms(kernel, 20)}


def run_one(root: str) -> int:
    """Every measurement of the module docstring for the checkout at
    root, in this process."""
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", OWN_SMOKE)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.training.system import RowsCompactTrainer

    names = cs.SCATTER_KERNEL_NAMES + cs.WARP_BLEND_KERNEL_NAMES
    emit(root, {"card": torch.cuda.get_device_name(0)})
    for tag, cfg, rig in (("step", cs.FLAGSHIP_CFG, cs.smpl_rig),
                          ("step_k8", cs.K8_CFG, cs.rigid_smpl_rig)):
        system = AnimNeRFSystem(cfg, rig(), device="cuda", seed=0)
        trainer = RowsCompactTrainer(system, steps_per_epoch=100)
        batches = cs.train_batches(16, 1024, range(2), "cuda")
        trainer.step(batches[1])  # warm-up
        emit(root, {"profile": tag, **cs.kernel_split(
            lambda: trainer.step(batches[0]), names, reps=1)})
        calls = cs.capture_scatter(lambda: trainer.step(batches[0]))
        del trainer, system
        for i, c in enumerate(calls):
            emit(root, {"scatter": f"{tag}_{i}", **cs.scatter_call_line(c),
                        **sorted_scatter_parts(c, cs)})
        del calls
        torch.cuda.empty_cache()

    # the scatter line of chip_smoke.py: uniform indices, every entry live
    g = torch.Generator(device="cuda").manual_seed(1)
    B, K, N, V = 16, 4, 32768, 6890
    idx = torch.randint(0, V, (B, K, N), generator=g, device="cuda",
                        dtype=torch.int32)
    w = torch.rand(B, K, N, generator=g, device="cuda")
    gr = torch.randn(B, 16, N, generator=g, device="cuda")
    gr[:, 12:] = 0.0
    c = {"idx": idx, "w": (w / w.sum(1, keepdim=True)).contiguous(),
         "g": gr, "num_rows": V}
    emit(root, {"scatter": "uniform", **cs.scatter_call_line(c),
                **sorted_scatter_parts(c, cs)})
    del c, idx, w, gr

    ck, system, bp, tmpl, _ = cs.scale512("cuda")
    system8 = cs.scale512_system(ck, "cuda", rigid=True, k_neigh=8)
    xsystem = cs.smplx_system()
    xbp, xtmpl = cs.smplx_params(1, 1), cs.smplx_params(1, 2,
                                                        zero_transl=True)
    for tag, view in (
            ("view", cs.view_fn(system, bp, tmpl, 3)),
            ("view_smplx", cs.view_fn(xsystem, xbp, xtmpl, 3,
                                      prepass="exact")),
            ("view_k8", cs.view_fn(system8, bp, tmpl, 3))):
        view()  # warm-up
        emit(root, {"profile": tag, **cs.kernel_split(view, names, reps=1)})
        calls = cs.capture_warp_blend(view)
        emit(root, {"warp_blend": tag, "calls": [[c["N"], c["k"]]
                                                 for c in calls],
                    **cs.warp_blend_call_line(calls[0]["args"])})
        del calls
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", help="checkouts, in run order")
    ap.add_argument("--run", help="run one checkout in this process")
    args = ap.parse_args()
    if args.run:
        return run_one(args.run)
    if not args.roots:
        ap.error("needs at least one ROOT")
    for root in args.roots:
        root = os.path.abspath(root)
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--run", root], cwd=root, timeout=1200)
        if r.returncode != 0:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
