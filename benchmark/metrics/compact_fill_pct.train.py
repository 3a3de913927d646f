"""Share of the coarse warp's and field's columns that are samples, not
padding to the largest row: 100 x the program's counter
``compact.survivors`` (the coarse survivors over every row) over
``compact.rows`` (rows x the padded capacity), the mean over the device
pass's steps."""

from harness import spans


def read(rec):
    return spans.mean([100.0 * c["counters"]["compact.survivors"]
                       / c["counters"]["compact.rows"]
                       for c in spans.calls(rec, "train.step")
                       if c["counters"].get("compact.rows")])
