"""What decides ``correct``: each number a kind's ``compare`` gives
(``kinds/<kind>.py`` says what its numbers are) held against its limit
from ``benchmark/checks/<cell>.json``; and the leaf-norm arithmetic of
the training numbers. PERF.md gives the readings each limit was set
from.
"""

from __future__ import annotations

import json
import math
import os
import statistics

# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone under Adam: its change is not compared
MOVE_SHARE = 1e-3


def norms(d: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in d.items()}


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """{leaf: gap of the norms over the larger of the reference's norm
    of the leaf and of the median leaf}."""
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}


def load_limits(bench_dir: str, cell: str) -> dict:
    path = os.path.join(bench_dir, "checks", cell + ".json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)["limits"]


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit: each finite and at or under it. No limit at all is not
    correct."""
    rows, ok = {}, bool(limits)
    for k, lim in limits.items():
        v = numbers[k]
        rows[k] = {"value": v, "limit": lim}
        if not math.isfinite(v) or v > lim:
            ok = False
    return ok, rows
