"""Model FLOPs of the window's training steps (rays within dis_threshold
of a posed vertex x the model's samples a ray x the field's FLOPs a
sample x 3 for forward and backward) over the window's wall time, as a
share of the card's bf16 peak."""


def read(rec):
    if not rec["peak_flops"]:
        return None
    w = rec["window"]
    return 100.0 * w["model_flop"] / w["seconds"] / rec["peak_flops"]
