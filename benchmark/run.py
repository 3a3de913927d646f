#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (``animnerf_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository root, on a machine with the cards the cell asks for.
One run: set-up from the seed (counted in ``setup_s``), the timed window,
with ``--trace 1`` a profiled sub-window after it, then the check of what
the window produced against the plain reference under
``benchmark/reference/``. Prints, last on standard error, each compared
number beside its limit, and last on standard output one JSON line.
Exits non-zero, with no result, without enough CUDA cards or when JAX or
the JAX package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules whose top-level name must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "animnerf_tpu")
HOST_THREADS = 1


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    from harness.manifest import Bench

    cell = Bench(ROOT).cell(args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
            f"available: {torch.cuda.device_count()}")
        return 2
    # one host thread for the harness's own CPU work: the timed paths run
    # on the card, and idle intra-op threads only compete for the host
    torch.set_num_threads(HOST_THREADS)
    # the program's build and kernel caches stay inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", sub))
    from harness.runner import run_cell

    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START, log=log)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3
    for name, row in result["checks"].items():
        log(f"check {name} {row['value']!r} limit {row['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
