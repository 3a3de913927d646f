#!/usr/bin/env python3
"""Readings that set a cell's limits (not run by the benchmark's runs):

    python3 benchmark/readings.py --workload <cell> --seeds 1-12 \
        [--control 3] [--faults 3]

For each seed, in one process: the cell's set-up and what its timed path
produces for the check (a training cell's first steps, a view cell's
checked views), held against the reference: the program's readings. On
the first ``--control`` seeds also the control (the reference with its
field in float8 e4m3 and its geometry in TF32, in the program's place),
and on the first ``--faults`` seeds each fault the cell's kind names
(``faults``: for a training cell, half of the batch left out and the
mean taken over the rest). One JSON line per reading.
"""

import json
import os
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def seeds(spec: str) -> list:
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def readings(root: str, workload: str, seed_list, n_control: int,
             n_fault: int, device: str = "cuda"):
    import torch

    from harness.manifest import Bench

    b = Bench(root)
    entry = b.cell(workload)
    for i, seed in enumerate(seed_list):
        run = SimpleNamespace(root=root, seed=seed,
                              device=torch.device(device),
                              config=b.config(entry["config"]),
                              traffic=b.traffic(entry["traffic"]))
        kind = b.kind(run.traffic["kind"])
        t0 = time.perf_counter()
        cell = kind(run)
        out = cell.outputs()
        cell.release()
        ref = cell.reference()
        yield {"seed": seed, "what": "program", **kind.compare(out, ref),
               "seconds": time.perf_counter() - t0,
               **cell.diagnostics(out, ref)}
        if i < n_control:
            ctl = cell.reference("fp8")
            yield {"seed": seed, "what": "control", **kind.compare(ctl, ref),
                   **cell.diagnostics(ctl, ref)}
        del cell, out
        for name, wrap in kind.faults.items() if i < n_fault else ():
            bad = kind(run, wrap=wrap)
            o = bad.outputs()
            bad.release()
            yield {"seed": seed, "what": name,
                   **kind.compare(o, bad.reference())}
            del bad, o


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [HERE, ROOT]
    for r in readings(ROOT, args.workload, seeds(args.seeds), args.control,
                      args.faults):
        print(json.dumps(dict(workload=args.workload, **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
