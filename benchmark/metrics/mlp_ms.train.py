"""Device ms a traced training step in kernels 3 and 6 (the fused MLP
forward, its backward's main kernel and weight-gradient passes)."""

from harness import kernels, trace


def read(rec):
    t = rec["trace"]
    secs = trace.device_seconds(t["by_name"],
                                kernels.MLP_FWD + kernels.MLP_BWD)
    return 1e3 * secs / t["count"] if secs > 0 else None
