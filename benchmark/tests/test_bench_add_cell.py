"""A later change adds a configuration, a traffic mix, a kind of cell, a
cell and a per-layer metric as new files and entries, and the harness
runs them without an edit to any file it already has."""

import json
import os
import time

import numpy as np

from harness.manifest import Bench
from harness.runner import run_cell


def test_new_cell_as_files_only(tiny):
    b = os.path.join(tiny, "benchmark")
    before = {}
    for d, _, files in os.walk(b):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                before[os.path.join(d, f)] = fh.read()
    # a new configuration (another vertex count), traffic mix and metric
    with open(os.path.join(b, "configs", "tiny.json")) as f:
        c = json.load(f)
    c.update(name="tiny_v400", num_verts=400, rig_seed=5)
    with open(os.path.join(b, "configs", "tiny_v400.json"), "w") as f:
        json.dump(c, f)
    with open(os.path.join(b, "traffic", "tiny_train.json")) as f:
        t = json.load(f)
    t.update(batch=3, pool=2, pool_seed=99)
    with open(os.path.join(b, "traffic", "tiny_train_b3.json"), "w") as f:
        json.dump(t, f)
    limits = {"loss_gap": 1.0, "delta_gap": 1.0}
    with open(os.path.join(b, "checks", "tiny_v400.train.json"), "w") as f:
        json.dump({"limits": limits}, f)
    with open(os.path.join(b, "metrics", "steps_in_window.py"), "w") as f:
        f.write("def read(rec):\n"
                "    return float(rec['window']['count'])\n")
    with open(os.path.join(tiny, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["configs"].append({"name": "tiny_v400", "source": "test",
                         "file": "benchmark/configs/tiny_v400.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "tiny_v400.train", "config": "tiny_v400",
                           "traffic": "tiny_train_b3", "chips": 1,
                           "why": "test"})
    m["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "training entry",
                           "moves": "train_rays_per_s",
                           "workloads": ["tiny_v400.train"]})
    for e in m["end_to_end"]:
        if e["name"] == "train_rays_per_s":
            e["workloads"].append("tiny_v400.train")
    with open(os.path.join(tiny, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    r0 = run_cell(tiny, "tiny_v400.train", 2 ** 31 + 1, 0.5, False, "cpu",
                  time.perf_counter())
    assert r0["attempted"] > 0 and r0["failed"] == 0
    assert set(r0["metrics"]) == {"train_rays_per_s", "setup_s"}
    r1 = run_cell(tiny, "tiny_v400.train", 2 ** 31 + 2, 0.5, True, "cpu",
                  time.perf_counter())
    assert r1["metrics"]["steps_in_window"]["value"] == r1["attempted"]
    assert list(r1)[-1] == "checks"
    assert set(r1["checks"]) == set(limits) and r1["correct"]
    for path, data in before.items():
        with open(path, "rb") as fh:
            assert fh.read() == data, path


POSED_VIEW = '''"""Traffic kind posed_view: the view kind with a new pose every view,
drawn from the mix's pose_seed."""

import numpy as np

from harness import traffic
from kinds import view


class Cell(view.Cell):
    kind = "posed_view"

    def pose(self, v):
        if not hasattr(self, "poses"):
            self.poses = traffic.draw_poses(
                self.config["model_type"], self.st["n_views"],
                np.random.default_rng(self.traffic["pose_seed"]),
                self.traffic["pose_scale"], turn=False)
        obs, tmpl = self.poses
        return {k: a[:1] if k == "betas" else a[v:v + 1]
                for k, a in obs.items()}, tmpl
'''


def test_new_kind_as_files_only(tiny):
    b = os.path.join(tiny, "benchmark")
    before = {}
    for d, _, files in os.walk(b):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                before[os.path.join(d, f)] = fh.read()
    # a new kind of cell (a view with a new pose every view), a mix of it
    # and a cell under it
    with open(os.path.join(b, "kinds", "posed_view.py"), "w") as f:
        f.write(POSED_VIEW)
    with open(os.path.join(b, "traffic", "tiny_view.json")) as f:
        t = json.load(f)
    t.update(kind="posed_view", pose_seed=4)
    with open(os.path.join(b, "traffic", "tiny_posed.json"), "w") as f:
        json.dump(t, f)
    limits = {"rgb_rms": 0.02, "alpha_rms": 0.02, "depth_rms": 0.05}
    with open(os.path.join(b, "checks", "tiny.posed.json"), "w") as f:
        json.dump({"limits": limits}, f)
    with open(os.path.join(tiny, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["workloads"].append({"name": "tiny.posed", "config": "tiny",
                           "traffic": "tiny_posed", "chips": 1,
                           "why": "test"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "tiny.view" in e.get("workloads", ()):
            e["workloads"].append("tiny.posed")
    with open(os.path.join(tiny, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    kind = Bench(tiny).kind("posed_view")
    cell = kind.__new__(kind)
    cell.config = Bench(tiny).config("tiny")
    cell.traffic, cell.st = t, {"n_views": t["views"]}
    p0, p1 = cell.pose(0)[0], cell.pose(1)[0]
    assert np.array_equal(p0["betas"], p1["betas"])
    assert not np.array_equal(p0["body_pose"], p1["body_pose"])
    r0 = run_cell(tiny, "tiny.posed", 2 ** 31 + 5, 0.5, False, "cpu",
                  time.perf_counter())
    assert r0["attempted"] > 0 and r0["failed"] == 0 and r0["correct"]
    assert set(r0["metrics"]) == {"view_fps", "view_p95_ms", "setup_s"}
    r1 = run_cell(tiny, "tiny.posed", 2 ** 31 + 6, 0.5, True, "cpu",
                  time.perf_counter())
    assert r1["correct"], r1["checks"]
    assert "survivor_pct.view" in r1["metrics"]
    for path, data in before.items():
        with open(path, "rb") as fh:
            assert fh.read() == data, path
