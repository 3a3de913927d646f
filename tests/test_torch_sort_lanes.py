"""The port's lane permute / gather (plain version) against the TPU kernel
``_permute_lanes_pallas`` in interpret mode, on the CPU: exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from animnerf_tpu.ops.sort_lanes import _permute_lanes_pallas
from animnerf_tpu_torch.ops.sort_lanes import gather_lanes, permute_lanes

torch.set_num_threads(1)


def test_permute_lanes_matches_kernel():
    rng = np.random.default_rng(0)
    pay = rng.normal(size=(2, 5, 19, 128)).astype(np.float32)
    order = np.argsort(rng.random((2, 19, 128)), -1).astype(np.int32)
    a = np.asarray(_permute_lanes_pallas(jnp.asarray(pay), jnp.asarray(order),
                                         interpret=True))
    b = permute_lanes(torch.from_numpy(pay), torch.from_numpy(order)).numpy()
    np.testing.assert_array_equal(a, b)


def test_gather_lanes_matches_kernel():
    rng = np.random.default_rng(1)
    L, J = 63, 32  # sample_fine: Kc-1 CDF knots, Kf lookups
    pay = rng.normal(size=(1, 2, 37, L)).astype(np.float32)
    idx = rng.integers(0, L, size=(1, 37, J)).astype(np.int32)
    a = np.asarray(_permute_lanes_pallas(
        jnp.pad(jnp.asarray(pay), ((0, 0), (0, 0), (0, 0), (0, 128 - L))),
        jnp.pad(jnp.asarray(idx), ((0, 0), (0, 0), (0, 128 - J))),
        interpret=True))[..., :J]
    b = gather_lanes(torch.from_numpy(pay), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(a, b)
