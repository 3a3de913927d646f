"""Host ms a traced view in the ray cull and the sample pre-pass (the
program's spans ``view.cull`` and ``compact.prepass``, their waits
included), the mean over the device pass's views."""

from harness import spans


def read(rec):
    return spans.mean([spans.span_ms(c, ("view.cull", "compact.prepass"))
                       for c in spans.calls(rec, "view.frame")])
