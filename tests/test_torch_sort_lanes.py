"""The port's lane permute / gather (plain version) against the TPU kernel
``_permute_lanes_pallas`` in interpret mode, on the CPU, the permute's
inverse-permutation backward, and the survivor compaction's rank tables
and permutations (``ops/perm_sort.py``) against the JAX package's: exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
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


def test_permute_lanes_backward_is_the_inverse_permute():
    rng = np.random.default_rng(2)
    pay = torch.from_numpy(rng.normal(size=(2, 5, 7, 128)).astype(np.float32))
    order = torch.from_numpy(
        np.argsort(rng.random((2, 7, 128)), -1).astype(np.int32))
    inv = torch.argsort(order.long(), dim=-1).to(torch.int32)
    ct = torch.from_numpy(rng.normal(size=(2, 5, 7, 128)).astype(np.float32))
    x = pay.clone().requires_grad_()
    (permute_lanes(x, order, inv) * ct).sum().backward()
    np.testing.assert_array_equal(
        x.grad.numpy(), torch.gather(ct, 3, inv.long()[:, None].expand(
            2, 5, 7, 128)).numpy())
    with pytest.raises(ValueError, match="inv"):
        permute_lanes(pay.clone().requires_grad_(), order)


def _keep_and_rows(seed=0, B=2, N=500):
    rng = np.random.default_rng(seed)
    keep = rng.random((B, N)) < 0.4
    xyz = rng.normal(size=(3, B, N)).astype(np.float32)
    return keep, xyz


@pytest.mark.parametrize("morton", [False, True])
def test_compaction_ranks_match_jax(morton):
    """o, inv and n equal the JAX package's rank tables exactly, with the
    survivors in original or Morton order."""
    from animnerf_tpu.ops.perm_sort import compaction_ranks as j_ranks
    from animnerf_tpu_torch.ops.perm_sort import compaction_ranks

    keep, xyz = _keep_and_rows()
    jo, jinv, jn = j_ranks(jnp.asarray(keep), xyz_rows=tuple(
        jnp.asarray(c) for c in xyz) if morton else None)
    o, inv, n = compaction_ranks(torch.from_numpy(keep), xyz_rows=tuple(
        torch.from_numpy(c) for c in xyz) if morton else None)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    assert int(n) == int(jn) == int(keep.sum(1).max())


def test_compact_expand_channels_and_grads_match_jax():
    """compact_channels / expand_channels and their inverse-gather
    gradients against the JAX sort-permutation twins: exact."""
    import jax

    from animnerf_tpu.ops import perm_sort as JP
    from animnerf_tpu_torch.ops import perm_sort as TP

    keep, xyz = _keep_and_rows(seed=1)
    cap = int(keep.sum(1).max())
    rng = np.random.default_rng(5)
    ct = rng.normal(size=(3, 2, 500)).astype(np.float32)
    jo, jinv, _ = JP.compaction_ranks(jnp.asarray(keep))

    def jf(vals):
        sel = JP.compact_channels(vals, jo, jinv, cap)
        dense = JP.expand_channels(tuple(2.0 * v for v in sel),
                                   (0.0, 0.0, -1e5), jo, jinv)
        return sum(jnp.sum(d * c) for d, c in zip(dense, ct)), dense

    (_, jdense), jg = jax.value_and_grad(jf, has_aux=True)(
        tuple(jnp.asarray(c) for c in xyz))
    o, inv, _ = TP.compaction_ranks(torch.from_numpy(keep))
    vals = tuple(torch.from_numpy(c).requires_grad_() for c in xyz)
    sel = TP.compact_channels(vals, o, inv, cap)
    dense = TP.expand_channels(tuple(2.0 * v for v in sel),
                               (0.0, 0.0, -1e5), o, inv)
    sum((d * torch.from_numpy(c)).sum() for d, c in zip(dense, ct)).backward()
    for a, b in zip(dense, jdense):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    for v, g in zip(vals, jg):
        np.testing.assert_array_equal(v.grad.numpy(), np.asarray(g))
