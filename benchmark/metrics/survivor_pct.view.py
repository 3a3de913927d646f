"""Samples through the field in the traced views (``Renderer.last_counts``:
coarse survivors twice, fine survivors once) over the model work's
samples of those views (rays within dis_threshold of a posed vertex x
the model's samples a ray)."""


def read(rec):
    t = rec["trace"]
    if not t.get("model_samples") or not t.get("view_counts"):
        return None
    rows = sum(2 * c + f for c, f in t["view_counts"])
    return 100.0 * rows / t["model_samples"]
