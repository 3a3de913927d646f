"""Share of the traced sub-window in which no kernel, copy or fill ran on
the card (the union of their intervals, not their sum)."""


def read(rec):
    t = rec["trace"]
    if t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
