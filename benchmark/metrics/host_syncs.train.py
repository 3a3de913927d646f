"""Wait spans a traced step: the program's blocking reads of the card
(``wait.*``), the mean over the device pass's steps."""

from harness import spans


def read(rec):
    return spans.mean([float(len(spans.waits(c)))
                       for c in spans.calls(rec, "train.step")])
