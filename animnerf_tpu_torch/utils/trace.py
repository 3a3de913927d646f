"""Spans and counters at the port's layer boundaries.

``span(name)`` times a stretch of host code, ``wait(name)`` a span that
blocks on the card (a device-to-host read, a ``torch.nonzero``, an upload
from pageable memory), ``count(name, value)`` adds to a counter. A root
span (``span(name, root=True)``: ``train.step`` in the trainers'
``step``, ``view.frame`` in ``Renderer.render_frame``) opens one call
record; the spans, counters and kernel launches (``LAUNCHES``) made until
it closes go into that record, which then joins a ring of the last
``RING`` calls (``calls()``, ``clear()``).

The tracer is on only while a ``torch.profiler`` session runs or inside
``recording()``. Off, ``span`` reads two flags and returns one shared
no-op object: nothing is allocated, no profiler API is called, no CUDA
call is made. On, a span's start and end are ``time.time_ns()`` (the
Unix clock, which the profiler's exported trace counts from its
``baseTimeNanoseconds``), and under a profiler the span also opens a
range (what ``record_function(name)`` opens), so it lands in the trace
as a ``user_annotation`` on the device trace's timeline. The tracer
adds no host synchronisation: a counter's tensor values are summed when
``calls()`` reads the record.

One stack of open spans serves the process: the autograd engine's worker
threads run while the step's thread waits in ``backward``, so a span
opened there nests under ``train.backward``. Spans opened outside a
root call reach the profiler but no record.

Span names (PERF.md maps each to its metric): ``train.step``,
``train.forward``, ``train.backward``, ``train.optimizer``, ``loss``,
``view.frame``, ``view.cull``, ``body.frame``, ``compact.prepass``,
``warp``, ``field``, ``composite``, and the waits ``wait.*``; counters
``compact.survivors``, ``compact.rows``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time

import torch
from torch.autograd import profiler as _profiler

# a profiler range: the entry that ``torch.profiler`` itself calls, at
# about a quarter of ``record_function``'s host time (which dispatches an
# operator). A session that records no CPU operation (a CUDA-only one)
# keeps no range, but pays for it all the same
_range_enter = torch.autograd._record_function_with_args_enter
_range_exit = torch.autograd._record_function_with_args_exit

# calls kept (the ring's length)
RING = 64

# kernel launches by wrapper (``ops/_build.py`` re-exports this dict):
# "knn_tile_skip" counts the kNN launches with the tile skip on (they also
# count under "knn", the kernel's total), "knn_exact_cull" the exact kNN's
# launches with the cull on (also under "knn_exact"); "fused_mlp_wgrad"
# the bf16 MLP backward's weight-gradient pass, launched by fused_nerf_bwd
# (which also counts under "fused_mlp_bwd") or alone by fused_nerf_wgrad;
# "knn_far" the all-far skip's pass, launched by a kNN wrapper in front of
# its sweep when far_skip > 0; "warp_blend_view_dir" the warp-blend's
# launches with warp_view on (also counted under "warp_blend");
# "fused_mlp_f32" / "fused_mlp_bwd_f32" the MLP kernels' float32 launches
# (also counted under "fused_mlp" / "fused_mlp_bwd"); "knn_packed_wide" /
# "knn_exact_wide" the kNN launches on the warp-per-point kernels (also
# counted under "knn_packed" / "knn_exact"); "warp_blend_group" the
# warp-blend's launches on its group kernel (also under "warp_blend")
LAUNCHES = {"knn": 0, "knn_tile_skip": 0, "warp_blend": 0,
            "warp_blend_view_dir": 0, "warp_blend_group": 0, "scatter": 0,
            "fused_mlp": 0, "fused_mlp_bwd": 0, "fused_mlp_wgrad": 0,
            "fused_mlp_f32": 0, "fused_mlp_bwd_f32": 0,
            "permute_lanes": 0, "knn_exact": 0, "knn_exact_cull": 0,
            "min_dist": 0, "knn_packed": 0, "knn_mxu": 0, "knn_far": 0,
            "knn_packed_wide": 0, "knn_exact_wide": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _Off:
    """The span returned while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Tracer:
    """The process's open spans, its open call record and the ring."""

    def __init__(self):
        self.recording = 0
        self.stack = []          # indices of the open call's open spans
        self.call = None         # the open call record
        self.ring = collections.deque(maxlen=RING)
        self.ids = itertools.count(1)

    def open_call(self, root: str) -> None:
        self.call = {"id": next(self.ids), "root": root, "spans": [],
                     "counters": {}, "launches": dict(LAUNCHES)}
        self.stack = []

    def close_call(self) -> None:
        call, self.call, self.stack = self.call, None, []
        before = call["launches"]
        call["launches"] = {k: v - before.get(k, 0)
                            for k, v in LAUNCHES.items()
                            if v != before.get(k, 0)}
        self.ring.append(call)


TRACER = Tracer()


class _Span:
    __slots__ = ("name", "root", "is_wait", "index", "owns_call", "rf")

    def __init__(self, name: str, root: bool, is_wait: bool):
        self.name = name
        self.root = root
        self.is_wait = is_wait
        self.index = None
        self.owns_call = False
        self.rf = None

    def __enter__(self):
        T = TRACER
        if self.root and T.call is None:
            T.open_call(self.name)
            self.owns_call = True
        t0 = time.time_ns()
        if _profiler._is_profiler_enabled:
            # the range's own stamp falls inside its enter: take the
            # middle of the enter, and the end after the exit (whose stamp
            # comes late), so both agree with the trace within microseconds
            self.rf = _range_enter(self.name)
            t0 = (t0 + time.time_ns()) // 2
        call = T.call
        if call is not None:
            spans = call["spans"]
            self.index = len(spans)
            spans.append({"name": self.name,
                          "parent": T.stack[-1] if T.stack else -1,
                          "call": call["id"], "wait": self.is_wait,
                          "t0": t0, "t1": None})
            T.stack.append(self.index)
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            _range_exit(self.rf)
        T = TRACER
        if self.index is not None and T.call is not None:
            T.call["spans"][self.index]["t1"] = time.time_ns()
            if self.index in T.stack:
                del T.stack[T.stack.index(self.index):]
        if self.owns_call:
            T.close_call()
        return False


def on() -> bool:
    """Whether spans and counters are recorded now."""
    return bool(TRACER.recording or _profiler._is_profiler_enabled)


def span(name: str, root: bool = False):
    """A context manager timing the code inside it as span ``name``;
    ``root`` opens a call record when none is open."""
    if not (TRACER.recording or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, root, False)


def wait(name: str):
    """A span around a call that blocks until the card has caught up."""
    if not (TRACER.recording or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, False, True)


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a 0-d tensor summed when the record is
    read) to counter ``name`` of the open call."""
    if not (TRACER.recording or _profiler._is_profiler_enabled):
        return
    call = TRACER.call
    if call is not None:
        call["counters"].setdefault(name, []).append(value)


def wait_in_backward(node, name: str) -> None:
    """Time the backward of autograd node ``node`` (a ``grad_fn``) as the
    wait span ``name``: for a node whose backward reads the card."""
    if not (TRACER.recording or _profiler._is_profiler_enabled):
        return
    held = []

    def pre(grad_outputs):
        held.append(_Span(name, False, True).__enter__())

    def post(grad_inputs, grad_outputs):
        if held:
            held.pop().__exit__(None, None, None)

    node.register_prehook(pre)
    node.register_hook(post)


def open_spans() -> list:
    """Names of the open call's open spans, outermost first."""
    call = TRACER.call
    if call is None:
        return []
    return [call["spans"][i]["name"] for i in TRACER.stack]


def _resolve(call: dict) -> dict:
    for name, vals in call["counters"].items():
        if isinstance(vals, list):
            call["counters"][name] = sum(
                int(v.item()) if torch.is_tensor(v) else int(v)
                for v in vals)
    return call


def calls() -> list:
    """The ring's call records, oldest first: {"id", "root", "spans":
    [{"name", "parent" (index in "spans", -1 for the root), "call",
    "wait", "t0", "t1" (Unix ns)}], "counters": {name: int}, "launches":
    {wrapper: launches in the call}}."""
    return [_resolve(c) for c in TRACER.ring]


def clear() -> None:
    TRACER.ring.clear()


@contextlib.contextmanager
def recording():
    """Record spans and counters without a profiler (host times only)."""
    TRACER.recording += 1
    try:
        yield
    finally:
        TRACER.recording -= 1
