"""On the card, at each cell's own size: the program's readings on three
seeds pass the cell's limits and the control's (the reference with its
field in float8 e4m3 and its geometry in TF32, in the program's place)
fail at least one of them. Skips without a CUDA card.

    python -m pytest benchmark/tests/test_bench_card.py -q -m card
"""

import json
import os

import pytest
import torch

from conftest import ROOT
from harness import check

import readings


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", _cells())
def test_control_fails_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = check.load_limits(os.path.join(ROOT, "benchmark"), cell)
    rows = list(readings.readings(ROOT, cell, [101, 102, 103], 3, 0))
    for r in rows:
        numbers = {k: v for k, v in r.items()
                   if isinstance(v, float) and k != "seconds"}
        ok, _ = check.judge(numbers, limits)
        assert ok == (r["what"] == "program"), r
