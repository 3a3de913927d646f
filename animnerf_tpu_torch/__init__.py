"""animnerf_tpu_torch — the PyTorch/CUDA port of animnerf_tpu for NVIDIA Hopper.

A package of its own beside the JAX one: it imports torch and numpy, never
jax, flax, optax or anything from ``animnerf_tpu``. Module layout and names
follow the JAX package so each function has an obvious counterpart.

It covers the flagship model's serving path, compacted novel-view
rendering (``render/inference.py::Renderer``, with the box or the exact
nearest-vertex pre-pass), and its training step
(``training/system.py::RowsCompactTrainer``), for the five SMPL-family
body models (SMPL, SMPL-H, SMPL-X, MANO, FLAME). Their kernels (packed kNN
with the tile skip, exact kNN for clouds above 8192 vertices such as
SMPL-X's, nearest-vertex distance, warp-blend and its backward scatter,
fused MLP forward and backward, lane permute) are CUDA C++ under
``csrc/``, built for ``sm_90a`` at first use (``ops/_build.py``).
"""

__all__ = []
