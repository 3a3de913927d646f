"""Host ms a traced training step in the forward (the program's span
``train.forward``), the mean over the device pass's steps."""

from harness import spans


def read(rec):
    return spans.mean([spans.span_ms(c, ("train.forward",))
                       for c in spans.calls(rec, "train.step")])
