"""CPU tests of the benchmark harness. Tests that need a CUDA card carry
the ``card`` marker and skip without one (decided inside each test).

    python -m pytest benchmark/tests -q
"""

import json
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


# a cell small enough for the CPU: the flagship field's widths (the
# program's are fixed), few vertices, samples and rays
TINY_CONFIG = {"name": "tiny", "num_verts": 300, "n_samples": 16,
               "n_importance": 8}
TINY_TRAIN = {"batch": 2, "patch": 4, "pool": 4, "img": 64,
              "fg_points": 8, "bg_points": 8, "profile_count": 2}
TINY_VIEW = {"img": 32, "views": 8, "check_views": 2, "profile_count": 2,
             "warmup_views": 1}


def make_tiny(root: str, limits: dict = None) -> str:
    """A copy of the benchmark under ``root`` with the cells
    ``tiny.train`` and ``tiny.view`` added as files and entries only."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH_DIR, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "smpl_male3casual.json")) as f:
        c = json.load(f)
    c.update(TINY_CONFIG)
    c["train"]["frame_end_ID"] = 20
    with open(os.path.join(b, "configs", "tiny.json"), "w") as f:
        json.dump(c, f)
    for name, src, over in (("tiny_train", "train_b16x1024", TINY_TRAIN),
                            ("tiny_view", "turntable512_opaque", TINY_VIEW)):
        with open(os.path.join(b, "traffic", src + ".json")) as f:
            t = json.load(f)
        t.update(over)
        with open(os.path.join(b, "traffic", name + ".json"), "w") as f:
            json.dump(t, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["configs"].append({"name": "tiny", "source": "test",
                         "file": "benchmark/configs/tiny.json",
                         "reduced": [], "why": "test"})
    cells = {"tiny.train": "tiny_train", "tiny.view": "tiny_view"}
    for cell, traffic in cells.items():
        m["workloads"].append({"name": cell, "config": "tiny",
                               "traffic": traffic, "chips": 1,
                               "why": "test"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "workloads" in e:
            kind = "train" if any(".train" in w for w in e["workloads"]) \
                else "view"
            e["workloads"].append(f"tiny.{kind}")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    for cell, lim in (limits or {}).items():
        with open(os.path.join(b, "checks", cell + ".json"), "w") as f:
            json.dump({"limits": lim}, f)
    return root


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(str(tmp_path))
