"""Device ms a traced training step in the kNN kernels (1, 8, 9:
sweeps, rows kernels, warp-per-point kernels, the far pass)."""

from harness import kernels, trace


def read(rec):
    t = rec["trace"]
    secs = trace.device_seconds(t["by_name"], kernels.KNN)
    return 1e3 * secs / t["count"] if secs > 0 else None
