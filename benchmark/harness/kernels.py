"""The program's hand kernels by profiler name (substrings of the
demangled names, as ``chip_smoke.py`` lists them), and the card's peaks.
"""

# kernel 3, the fused MLP forward (bf16 on wgmma; f32)
MLP_FWD = ("mlp_fwd_bf16", "mlp_fwd_f32", "fused_mlp_f32_kernel")
# kernel 6, the fused MLP backward: its main kernel and the weight
# gradients, sums and split reduction
MLP_BWD = ("mlp_bwd_main", "mlp_wgrad", "reduce_splits", "wgrad_f32",
           "wgrad_heads", "bias_sums")
# kernels 1, 8 and 9 (sweeps, rows kernels, warp-per-point kernels) and
# the far pass of their all-far skip
KNN = ("knn_sweep::", "knn_rows_kernel", "knn_exact", "knn_far_kernel",
       "knn_packed")

# dense bf16 tensor-core peak of one H100 SXM at 700 W (NVIDIA data sheet)
PEAK_BF16 = {"H100": 989e12}


def peak_flops(device_name: str) -> float:
    for key, v in PEAK_BF16.items():
        if key in device_name:
            return v
    raise ValueError(f"no peak recorded for {device_name!r}")
