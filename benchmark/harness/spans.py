"""The program's own spans and counters (``animnerf_tpu_torch/utils/
trace.py``) from the traced sub-window, for the readers of
``program_span`` and ``program_counter`` metrics.

After ``harness/program.py``, this is the second module to import the
program, and it does so only when a reader asks, inside ``calls``: a
program without the tracer gives no calls, and the readers then return
None. The tracer records while a ``torch.profiler`` session runs, which
is only in ``harness/trace.py::profile``: each of its passes runs one
warm call and then ``count`` timed calls, the device-only pass first. On
a card the ring's last ``2 * (count + 1)`` calls are the two passes, and
the device pass's timed calls are the ``count`` calls after the first of
them: there the host runs closest to its untraced pace. Without a card
there is one pass, whose timed calls are the last ``count``.
"""

from __future__ import annotations


def calls(rec: dict, root: str) -> list:
    """The device pass's timed call records (``trace.calls()``), each a
    ``root`` call, or [] when the program recorded none."""
    try:
        from animnerf_tpu_torch.utils import trace
    except ImportError:
        return []
    import torch

    count = rec["trace"]["count"]
    got = trace.calls()
    if torch.cuda.is_available():
        got = got[-2 * (count + 1):][1:count + 1]
    else:
        got = got[-count:]
    if len(got) < count or any(c["root"] != root for c in got):
        return []
    return got


def _outermost_ms(call: dict, pick) -> float:
    """Host ms of the call's spans that ``pick`` accepts, a span inside
    another accepted one counted once (with its parent)."""
    spans = call["spans"]

    def inside(s) -> bool:
        p = s["parent"]
        while p >= 0:
            if pick(spans[p]):
                return True
            p = spans[p]["parent"]
        return False

    return sum(s["t1"] - s["t0"] for s in spans
               if pick(s) and not inside(s)) * 1e-6


def span_ms(call: dict, names) -> float:
    """Host ms of the call's spans named in ``names``."""
    return _outermost_ms(call, lambda s: s["name"] in names)


def waits(call: dict) -> list:
    """The call's wait spans (host blocked on the card)."""
    return [s for s in call["spans"] if s["wait"]]


def wait_ms(call: dict) -> float:
    """Host ms the call spent in wait spans."""
    return _outermost_ms(call, lambda s: s["wait"])


def mean(values: list):
    return sum(values) / len(values) if values else None
