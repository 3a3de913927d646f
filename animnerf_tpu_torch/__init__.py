"""animnerf_tpu_torch — the PyTorch/CUDA port of animnerf_tpu for NVIDIA Hopper.

A package of its own beside the JAX one: it imports torch and numpy, never
jax, flax, optax or anything from ``animnerf_tpu``. Module layout and names
follow the JAX package so each function has an obvious counterpart.

This slice covers the serving path: compacted novel-view rendering of a
trained flagship model (``render/inference.py::Renderer``). Its four
kernels (kNN, warp-blend, fused MLP, lane permute) are CUDA C++ under
``csrc/``, built for ``sm_90a`` at first use (``ops/_build.py``).
"""

__all__ = []
