"""Host ms a traced training step in the optimizer (the program's span
``train.optimizer``), the mean over the device pass's steps."""

from harness import spans


def read(rec):
    return spans.mean([spans.span_ms(c, ("train.optimizer",))
                       for c in spans.calls(rec, "train.step")])
