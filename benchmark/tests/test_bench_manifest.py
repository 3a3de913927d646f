"""BENCHMARK.json against the benchmark contract's rules, and every file
it names found by name."""

import json
import os
import re

from conftest import BENCH_DIR, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_units():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"] and 1 <= m["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
        assert metric["source"] in SOURCES
    for metric in m["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    assert "setup_s" in [x["name"] for x in m["end_to_end"]]
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 and len(w["why"]) <= 200
               for w in m["workloads"])


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_moves_reported_by_every_cell_of_the_metric():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for metric in m["per_layer"]:
        assert metric["moves"] in e2e, metric
        for cell in metric["workloads"]:
            assert _reports(e2e[metric["moves"]], cell), (metric, cell)
    for w in m["workloads"]:
        cell = w["name"]
        assert any(_reports(x, cell) for x in m["end_to_end"]
                   if x["name"] != "setup_s")
        assert any(_reports(x, cell) for x in m["per_layer"])


def test_every_named_file_exists():
    m = manifest()
    for c in m["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in m["workloads"]:
        for path in (("traffic", w["traffic"] + ".json"),
                     ("checks", w["name"] + ".json")):
            assert os.path.isfile(os.path.join(BENCH_DIR, *path)), path
    for metric in m["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH_DIR, "metrics",
                                           metric["name"] + ".py"))


def test_full_check_fits_with_24_cells():
    m = manifest()
    runs = 2 + 14 * 24
    total = runs * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
