"""Host ms a traced training step in the backward (the program's span
``train.backward``), the mean over the device pass's steps."""

from harness import spans


def read(rec):
    return spans.mean([spans.span_ms(c, ("train.backward",))
                       for c in spans.calls(rec, "train.step")])
