"""Device time from ``torch.profiler`` traces of two steady sub-windows.

The first is traced on the device alone (CUDA activities: kernels,
copies, fills), so the host runs at nearly its untraced pace; the
sub-window runs from the end of a marker kernel launched after a
synchronisation to the start of one launched after the calls have been
synchronised. From it: the busy time, the union of the device
activities' intervals (not their sum: two streams may overlap), the
device time by kernel name (their sum), the top device operations. The
second is traced on the host and the device together, inside the host
span ``bench.window``; recording every host operation slows a host-bound
call, so it serves only to name the idle gaps: the stretches of the
span with no device activity, each by the innermost host operation
running at its middle.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

WINDOW_SPAN = "bench.window"
# the marker kernel (``torch.cuda._sleep``) that bounds the device pass
MARK = "spin_kernel"
MARK_CYCLES = 1000
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# gaps shorter than this are launch latency between kernels
SHORT_GAP_US = 20.0
TOP = 10


def short_name(name: str) -> str:
    n = name[5:] if name.startswith("void ") else name
    for stop in ("<", "("):
        i = n.find(stop)
        if i > 0:
            n = n[:i]
    return n[:100]


def union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def bounds(events: list) -> tuple:
    """(start, end) in us of the sub-window: the host span
    ``bench.window``, or else the stretch between the first marker
    kernel's end and the last one's start, or else that of all device
    activity."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("name") == WINDOW_SPAN
             and e.get("cat") == "user_annotation"]
    if spans:
        t0 = float(spans[0]["ts"])
        return t0, t0 + float(spans[0]["dur"])
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"]) for e in events
                 if e.get("ph") == "X" and "dur" in e
                 and e.get("cat") in DEVICE_CATS)
    marks = [d for d in dev if MARK in d[2]]
    if len(marks) >= 2:
        return marks[0][1], marks[-1][0]
    if not dev:
        raise ValueError("no device activity and no span in the trace")
    return dev[0][0], max(d[1] for d in dev)


def reduce(events: list) -> dict:
    """Chrome-trace events -> {window_s, busy_s, by_name {full kernel
    name: s}, device_ops [[short name, s]], idle_gaps [[host op, s]]}."""
    t0, t1 = bounds(events)
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        end = s + float(e["dur"])
        if end <= t0 or s >= t1 or MARK in e["name"]:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append((e["name"], max(s, t0), min(end, t1)))
        elif e.get("cat") in HOST_CATS and e["name"] != WINDOW_SPAN:
            host.append((s, end, e["name"]))
    busy = union((s, e) for _, s, e in dev)
    by_name = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    short = {}
    for n, v in by_name.items():
        short[short_name(n)] = short.get(short_name(n), 0.0) + v
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    host.sort()
    starts = [h[0] for h in host]
    idle = {}
    for s, e in gaps:
        label = f"launch gaps under {SHORT_GAP_US:g} us"
        if e - s >= SHORT_GAP_US:
            label = "host between operations"
            mid = 0.5 * (s + e)
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4000, -1), -1):
                if host[j][1] >= mid:
                    label = host[j][2]
                    break
        idle[label] = idle.get(label, 0.0) + (e - s) * 1e-6
    return {"window_s": (t1 - t0) * 1e-6,
            "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "by_name": by_name,
            "device_ops": sorted(([k, v] for k, v in short.items()),
                                 key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:TOP]}


def device_seconds(by_name: dict, names) -> float:
    """Device seconds of the kernels whose names contain one of ``names``."""
    return sum(v for k, v in by_name.items() if any(n in k for n in names))


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def profile(fn, warm_fn, count: int) -> dict:
    """Run warm_fn once, then fn ``count`` times, in each of the two
    sub-windows; returns the device pass's reduce() with the idle gaps
    named by the host pass, and ``call_s``: each pass's seconds a call.
    Without a card: one host pass, and no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    from torch.profiler import record_function

    cuda = torch.cuda.is_available()
    out = {}
    if cuda:
        with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
            warm_fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(MARK_CYCLES)
            for _ in range(count):
                fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        out = reduce(_events(prof))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with prof_ctx(activities=acts) as prof:
        warm_fn()
        sync()
        with record_function(WINDOW_SPAN):
            for _ in range(count):
                fn()
            sync()
    host = reduce(_events(prof))
    if not cuda:
        out = dict(host)
    out["idle_gaps"] = host["idle_gaps"]
    out["call_s"] = {"device_pass": out["window_s"] / count,
                     "host_pass": host["window_s"] / count}
    return out
