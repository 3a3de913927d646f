"""``correct`` comes out false when the timed path is broken underneath
(the harness's look for a card skipped, the rest of a run driven on the
CPU at a tiny size), and the control (the reference with its field in
float8 and its geometry in TF32) reads above the program.

The tiny cell's limits sit above its sound runs' readings on the CPU;
the full cells' limits are set from chip runs (PERF.md). On the card the
control is run at the cells' own size by ``test_bench_card.py``.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import make_tiny
from harness.manifest import Bench
from harness.runner import run_cell
from kinds import train

TINY_LIMITS = {"tiny.train": {"loss_gap": 0.03, "grad_gap": 0.6,
                              "delta_gap": 0.05},
               "tiny.view": {"rgb_rms": 0.02, "alpha_rms": 0.02,
                             "depth_rms": 0.05}}


@pytest.fixture
def limited(tmp_path):
    return make_tiny(str(tmp_path), TINY_LIMITS)


def _run(root, cell, wrap=None, seed=2 ** 31 + 7):
    return run_cell(root, cell, seed, 0.3, False, "cpu",
                    time.perf_counter(), wrap=wrap)


def test_sound_runs_are_correct(limited):
    for cell in ("tiny.train", "tiny.view"):
        r = _run(limited, cell)
        assert r["correct"], r["checks"]


def test_unchanged_state_is_not_correct(limited):
    def frozen(trainer):
        def step(batch, noise):
            keep = [p.detach().clone() for p in trainer.system.parameters()]
            d = trainer.step(batch, noise)
            with torch.no_grad():
                for p, k in zip(trainer.system.parameters(), keep):
                    p.copy_(k)
            return d
        return step

    r = _run(limited, "tiny.train", frozen)
    assert not r["correct"] and r["checks"]["delta_gap"]["value"] == 1.0


def test_half_batch_is_not_correct(limited):
    r = _run(limited, "tiny.train", train.half_batch)
    assert not r["correct"], r["checks"]


def test_altered_answer_is_not_correct(limited):
    def altered(render_frame):
        def frame(*args, **kwargs):
            img, mask, depth = render_frame(*args, **kwargs)
            img = img.copy()
            img[: img.shape[0] // 4] += 0.1
            return img, mask, depth
        return frame

    r = _run(limited, "tiny.view", altered)
    assert not r["correct"], r["checks"]


def test_control_reads_above_the_program(limited):
    b = Bench(limited)
    for name in ("tiny.train", "tiny.view"):
        cell_entry = b.cell(name)
        prog, ctl = [], []
        for seed in (1, 2, 3):
            run = SimpleNamespace(root=limited, seed=seed,
                                  device=torch.device("cpu"),
                                  config=b.config(cell_entry["config"]),
                                  traffic=b.traffic(cell_entry["traffic"]))
            kind = b.kind(run.traffic["kind"])
            cell = kind(run)
            out = cell.outputs()
            ref = cell.reference()
            numbers = kind.compare
            prog.append(numbers(out, ref))
            ctl.append(numbers(cell.reference("fp8"), ref))
        # summed over the seeds, the control's first number is the larger
        key = next(iter(prog[0]))
        assert sum(c[key] for c in ctl) > 1.5 * sum(p[key] for p in prog), \
            (name, prog, ctl)
        assert np.isfinite([v for c in ctl for v in c.values()]).all()
