"""Kernel 3 (the fused MLP forward) in the traced views: the rows it
ran (coarse survivors through the coarse field, coarse and fine
survivors through the fine one, from ``Renderer.last_counts``) times the
field's FLOPs a row at the bf16 peak, over its device time by name."""

from harness import kernels, trace


def read(rec):
    t = rec["trace"]
    if not rec["peak_flops"] or not t.get("view_counts"):
        return None
    secs = trace.device_seconds(t["by_name"], kernels.MLP_FWD)
    if secs <= 0:
        return None
    rows = sum(2 * c + f for c, f in t["view_counts"])
    return 100.0 * rows * rec["flops_per_sample"] / rec["peak_flops"] / secs
