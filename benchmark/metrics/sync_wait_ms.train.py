"""Host ms a traced step blocked on the card: in the program's wait
spans (``wait.*``: device-to-host reads, ``torch.nonzero``, uploads
from pageable memory), the mean over the device pass's steps."""

from harness import spans


def read(rec):
    return spans.mean([spans.wait_ms(c)
                       for c in spans.calls(rec, "train.step")])
