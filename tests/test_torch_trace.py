"""The port's tracer (``animnerf_tpu_torch/utils/trace.py``) on the CPU:
off, a training step and a compacted view record nothing and call no
profiler API; under ``torch.profiler`` the spans come out named, nested
and grouped by call, on the exported trace's clock; the survivor counter
against an independent count; the ring's bound; one launch registry."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from animnerf_tpu_torch.data.synthetic import (
    make_body_model,
    random_pose_params,
)
from animnerf_tpu_torch.models.warp import prepare_frame, rays_to_root_frame
from animnerf_tpu_torch.ops import _build
from animnerf_tpu_torch.ops.ray_utils import camera_to_c2w, gen_rays
from animnerf_tpu_torch.render.inference import Renderer
from animnerf_tpu_torch.render.volume_renderer import sample_coarse
from animnerf_tpu_torch.system import AnimNeRFSystem
from animnerf_tpu_torch.training.system import (
    RowsCompactTrainer,
    _body_params,
)
from animnerf_tpu_torch.utils import trace
from animnerf_tpu_torch.utils.rng import draw_noise

NJ, B, R = 8, 2, 16

STEP_SPANS = {"train.step": None, "train.forward": "train.step",
              "train.backward": "train.step",
              "train.optimizer": "train.step", "loss": "train.forward",
              "compact.prepass": "train.forward", "warp": "train.forward",
              "field": "train.forward", "composite": "train.forward",
              "body.frame": "train.forward",
              "wait.survivors": "train.forward",
              "wait.cumprod": "train.backward"}
VIEW_SPANS = {"view.frame": None, "view.cull": "view.frame",
              "wait.cull": "view.cull", "body.frame": "view.frame",
              "compact.prepass": "view.frame", "warp": "view.frame",
              "field": "view.frame", "composite": "view.frame",
              "wait.survivors": "compact.prepass",
              "wait.scatter": "composite", "wait.to_host": "view.frame"}


@pytest.fixture(scope="module")
def rig():
    """A tiny system, a rows-engine trainer, a batch, a renderer and a
    view whose rays are culled (more rays than ``max_rays_per_call``)."""
    torch.manual_seed(0)
    system = AnimNeRFSystem({"n_samples": 8, "n_importance": 4,
                             "num_frames": 2, "pose_dim": 3 * (NJ - 1)},
                            make_body_model(64, NJ, seed=1), device="cpu")
    rng = np.random.default_rng(0)
    o = rng.normal(scale=0.1, size=(B, R, 3)).astype(np.float32)
    o[..., 2] += 3.0
    d = -o + rng.normal(scale=0.05, size=o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((B, R, 1), 0.1, np.float32),
                           np.full((B, R, 1), 10.0, np.float32)], -1)
    tmpl = random_pose_params(NJ, batch=B, seed=2)
    tmpl["transl"] = np.zeros_like(tmpl["transl"])
    batch = {"frame_idx": np.arange(B) % 2, "rays": rays,
             "rgbs": rng.uniform(size=(B, R, 3)).astype(np.float32),
             "alphas": rng.uniform(size=(B, R, 1)).astype(np.float32),
             "fg_points": rng.normal(scale=0.2, size=(B, 8, 3)).astype(
                 np.float32),
             "bg_points": rng.normal(scale=0.8, size=(B, 8, 3)).astype(
                 np.float32),
             **{k + "_template": v for k, v in tmpl.items()}}
    batch = {k: torch.tensor(v) for k, v in batch.items()}
    trainer = RowsCompactTrainer(system, steps_per_epoch=10)
    renderer = Renderer(system, device="cpu")
    renderer.max_rays_per_call = 64
    c2w = camera_to_c2w(np.eye(3), np.array([0.0, 0.0, 3.0]))
    view = (random_pose_params(NJ, batch=1, seed=1),
            {k: v[:1] for k, v in tmpl.items()},
            gen_rays(c2w, 16, 16, [19.2, 19.2], 0.1, 10.0).reshape(-1, 8))
    return system, trainer, batch, renderer, view


def _step(rig):
    _, trainer, batch, _, _ = rig
    return trainer.step(batch)


def _view(rig):
    *_, renderer, view = rig
    return renderer.render_frame(*view)


def test_off_records_nothing_and_calls_no_profiler_api(rig, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler API was called with tracing off")

    monkeypatch.setattr(trace, "_range_enter", refuse)
    monkeypatch.setattr(trace, "_Span", refuse)
    trace.clear()
    assert not trace.on()
    d = _step(rig)
    img, mask, depth = _view(rig)
    assert trace.calls() == []
    assert isinstance(d["compact_count"], int) and d["compact_count"] > 0
    assert rig[3].last_counts[0] > 0 and np.isfinite(img).all()


def _check_call(call: dict, want: dict) -> None:
    spans = call["spans"]
    names = {s["name"] for s in spans}
    assert set(want) <= names, set(want) - names
    root = spans[0]
    assert root["parent"] == -1 and root["name"] == call["root"]
    assert all(s["parent"] >= 0 for s in spans[1:])
    assert all(s["call"] == call["id"] for s in spans)
    for s in spans:
        assert s["t0"] <= s["t1"]
        if s["parent"] >= 0:
            p = spans[s["parent"]]
            assert p["t0"] <= s["t0"] and s["t1"] <= p["t1"]
        assert s["wait"] == s["name"].startswith("wait.")
    for name, parent in want.items():
        if parent is None:
            continue
        # each such span sits somewhere under its named ancestor
        for s in (s for s in spans if s["name"] == name):
            chain, p = [], s["parent"]
            while p >= 0:
                chain.append(spans[p]["name"])
                p = spans[p]["parent"]
            assert parent in chain, (name, chain)


def test_spans_named_nested_and_grouped_under_the_profiler(rig):
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        _step(rig)
        _step(rig)
        _view(rig)
    calls = trace.calls()
    assert [c["root"] for c in calls] == ["train.step", "train.step",
                                          "view.frame"]
    assert len({c["id"] for c in calls}) == 3
    for c in calls[:2]:
        _check_call(c, STEP_SPANS)
        assert c["counters"]["compact.survivors"] > 0
        assert c["counters"]["compact.rows"] % B == 0
    _check_call(calls[2], VIEW_SPANS)
    # the trainer's direct children: forward, backward, optimizer in turn
    top = [s["name"] for s in calls[0]["spans"] if s["parent"] == 0]
    assert top == ["train.forward", "train.backward", "train.optimizer"]


def _annotations(path: str):
    with open(path) as f:
        d = json.load(f)
    by_name = {}
    for e in d["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            by_name.setdefault(e["name"], []).append(e)
    return d["baseTimeNanoseconds"], by_name


def _clock_gaps_us(rig, tmp_path) -> list:
    """One profiled session (a warm call, then a step and a view): the
    largest gap in us between each checked span's start and end and its
    range's in the exported trace."""
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(rig)
        _step(rig)
        _view(rig)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    base, events = _annotations(path)
    calls = trace.calls()
    by_name = {}
    for c in calls:
        for s in c["spans"]:
            by_name.setdefault(s["name"], []).append((c["id"], s))
    gaps = []
    checked = {c["id"] for c in calls[1:]}
    for name, spans in by_name.items():
        evs = sorted(events.get(name, []), key=lambda e: e["ts"])
        assert len(evs) == len(spans), (name, len(evs), len(spans))
        for (cid, s), e in zip(sorted(spans, key=lambda x: x[1]["t0"]), evs):
            if cid in checked:
                start = (s["t0"] - base) / 1e3
                end = (s["t1"] - base) / 1e3
                gaps.append(max(abs(float(e["ts"]) - start),
                                abs(float(e["ts"]) + float(e["dur"]) - end)))
    return gaps


def test_spans_share_the_profiler_trace_clock(rig, tmp_path):
    """Each span of a step and a view is a ``user_annotation`` range of
    the exported trace whose start and end lie within 100 us of the
    tracer's, counted from ``baseTimeNanoseconds``. A host that preempts
    the test between the two clock reads can push one span past it, so
    the session is tried up to three times."""
    worst = []
    for attempt in range(3):
        gaps = _clock_gaps_us(rig, tmp_path)
        assert len(gaps) > 20
        worst.append(max(gaps))
        if worst[-1] < 100.0:
            break
    assert min(worst) < 100.0, worst


def test_survivor_counter_matches_a_dense_count(rig):
    """``compact.survivors`` against the box pre-pass recomputed in numpy
    on the step's coarse samples (the same noise), and ``compact.rows``
    against rows x the largest row."""
    system, trainer, batch, _, _ = rig
    noise = draw_noise(torch.Generator().manual_seed(5), B, R,
                       system.renderer_cfg,
                       system.body_model.num_verts)
    with trace.recording():
        d = trainer.step(batch, noise)
    c = trace.calls()[-1]
    with torch.no_grad():
        bp, bt = _body_params(system, batch)
        ctx = prepare_frame(system.body_model, bp, bt)
        rays = rays_to_root_frame(ctx, batch["rays"])
        z = sample_coarse(system.renderer_cfg, rays, 1.0, noise.coarse_u)
    rays, z = rays.numpy(), z.numpy()
    pts = (rays[:, :, None, 0:3] + z[..., None] * rays[:, :, None, 3:6]
           ).reshape(B, -1, 3)
    verts = ctx.verts_morton.numpy()
    V = verts.shape[1]
    thr = np.float32(system.scene_cfg.dis_threshold)
    # 64 index chunks of the Morton-sorted cloud, ceil(V / 64) vertices
    # each (an empty one past the end holds the last vertex)
    size = -(-V // min(64, V))
    keep = np.zeros(pts.shape[:2], bool)
    for b in range(B):
        for i in range(min(64, V)):
            chunk = verts[b, i * size:(i + 1) * size]
            if not len(chunk):
                chunk = verts[b, -1:]
            lo, hi = chunk.min(0) - thr, chunk.max(0) + thr
            keep[b] |= ((pts[b] >= lo) & (pts[b] <= hi)).all(-1)
    assert keep.sum() > 0
    assert c["counters"]["compact.survivors"] == int(keep.sum())
    assert c["counters"]["compact.rows"] == B * int(keep.sum(1).max())
    assert c["counters"]["compact.rows"] == B * d["compact_count"]


def test_ring_keeps_the_last_64_calls():
    trace.clear()
    with trace.recording():
        for i in range(trace.RING + 6):
            with trace.span("ring.call", root=True):
                trace.count("i", i)
                trace.count("i", torch.tensor(1000))
    calls = trace.calls()
    assert len(calls) == trace.RING == 64
    assert [c["counters"]["i"] for c in calls] == [
        i + 1000 for i in range(6, trace.RING + 6)]
    assert calls[-1]["id"] - calls[0]["id"] == trace.RING - 1
    trace.clear()
    assert trace.calls() == []


def test_launches_live_in_the_tracer():
    assert _build.LAUNCHES is trace.LAUNCHES
    assert _build.reset_launches is trace.reset_launches
    trace.clear()
    with trace.recording():
        with trace.span("launch.call", root=True):
            trace.LAUNCHES["knn"] += 2
    assert trace.calls()[-1]["launches"] == {"knn": 2}
