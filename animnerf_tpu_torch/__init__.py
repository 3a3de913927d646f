"""animnerf_tpu_torch — the PyTorch/CUDA port of animnerf_tpu for NVIDIA Hopper.

A package of its own beside the JAX one: it imports torch and numpy, never
jax, flax, optax or anything from ``animnerf_tpu``. Module layout and names
follow the JAX package so each function has an obvious counterpart.

It covers the flagship model's serving path, compacted novel-view
rendering (``render/inference.py::Renderer``), and its training step
(``training/system.py::RowsCompactTrainer``). Their kernels (kNN with the
tile skip, warp-blend and its backward scatter, fused MLP forward and
backward, lane permute) are CUDA C++ under ``csrc/``, built for ``sm_90a``
at first use (``ops/_build.py``).
"""

__all__ = []
