"""The per-layer metrics read from the program's spans and counters: the
tiny cells run traced on the CPU, and each metric reads a number."""

import time

import pytest

from harness import spans
from harness.runner import run_cell

TRAIN = ("fwd_host_ms.train", "bwd_host_ms.train", "opt_host_ms.train",
         "sync_wait_ms.train", "host_syncs.train", "compact_fill_pct.train")
VIEW = ("prepass_host_ms.view", "sync_wait_ms.view", "host_syncs.view")


@pytest.mark.parametrize("cell,names", [("tiny.train", TRAIN),
                                        ("tiny.view", VIEW)])
def test_span_metrics_read_numbers(tiny, cell, names):
    r = run_cell(tiny, cell, 2 ** 31 + 11, 0.3, True, "cpu",
                 time.perf_counter())
    for name in names:
        v = r["metrics"][name]["value"]
        assert isinstance(v, float) and v > 0, (name, v)
    if cell == "tiny.train":
        assert 0 < r["metrics"]["compact_fill_pct.train"]["value"] <= 100
    syncs = r["metrics"]["host_syncs." + cell.split(".")[1]]["value"]
    assert syncs == int(syncs) and syncs >= 1


def test_no_calls_read_none(monkeypatch):
    """A program without the tracer (or a run that traced nothing) gives
    no calls, and the readers return None."""
    from animnerf_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "calls", lambda: [])
    assert spans.calls({"trace": {"count": 2}}, "train.step") == []
    assert spans.mean([]) is None


def test_span_ms_counts_nested_names_once():
    call = {"spans": [
        {"name": "view.frame", "parent": -1, "wait": False, "t0": 0,
         "t1": 10_000_000},
        {"name": "view.cull", "parent": 0, "wait": False, "t0": 0,
         "t1": 2_000_000},
        {"name": "compact.prepass", "parent": 1, "wait": False,
         "t0": 0, "t1": 1_000_000},
        {"name": "wait.cull", "parent": 1, "wait": True, "t0": 1_000_000,
         "t1": 1_500_000},
        {"name": "compact.prepass", "parent": 0, "wait": False,
         "t0": 3_000_000, "t1": 6_000_000},
        {"name": "wait.survivors", "parent": 4, "wait": True,
         "t0": 4_000_000, "t1": 4_250_000}]}
    assert spans.span_ms(call, ("view.cull", "compact.prepass")) == 5.0
    assert spans.wait_ms(call) == 0.75
    assert len(spans.waits(call)) == 2
