"""The plain fields against the flax modules of the JAX package on the CPU:
``NeRFMLP`` with view directions and latent codes (forward, ``get_sigma``
and the input gradient of the normal term), ``DeRFMLP``,
``rotation_from_ortho6d`` and ``apply_deformation``, on parameters
carried across by ``utils/convert.py``; and the rule that picks the
fused MLP (kernel 3) or the plain one.

Tolerances: float32 atol 1e-5 (sums in another order), the DeRF's input
gradient rtol 1e-4 (its 2^9 frequencies); bfloat16 atol 2e-2 (a bf16
rounding of an activation may flip; ``tests/test_torch_render.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animnerf_tpu.models import nerf as JN
from animnerf_tpu_torch.models import nerf as TN
from animnerf_tpu_torch.utils.convert import net_params_from_flax

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
OPTIONS = [
    dict(use_view=True, freqs_dir=4),
    dict(use_view=True, freqs_dir=2, deformation_dim=8, apperance_dim=5),
    dict(deformation_dim=16, apperance_dim=16),
]


def _inputs(n: int, seed: int, dd: int, ad: int):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(scale=0.5, size=(2, n, 3)).astype(np.float32)
    vd = rng.normal(size=(2, n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    dc = rng.normal(scale=0.1, size=(2, n, dd)).astype(np.float32)
    ac = rng.normal(scale=0.1, size=(2, n, ad)).astype(np.float32)
    return xyz, vd, dc, ac


def _pair(opts: dict, dtype: str):
    """flax NeRFMLP params and the port's NeRFMLP carrying them."""
    jm = JN.NeRFMLP(freqs_xyz=10, compute_dtype=jnp.dtype(dtype), **opts)
    dd, ad = opts.get("deformation_dim", 0), opts.get("apperance_dim", 0)
    p = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 3)),
                jnp.zeros((1, 3)) if opts.get("use_view") else None,
                jnp.zeros((1, dd)) if dd else None,
                jnp.zeros((1, ad)) if ad else None)
    tm = TN.NeRFMLP(10, dtype, **opts)
    tm.load_state_dict(net_params_from_flax(
        "nerf", jax.tree.map(np.asarray, p)))
    return jm, p, tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(OPTIONS)))
def test_nerf_with_view_and_codes_matches_flax(case, dtype):
    """(rgb, sigma) and get_sigma; the port's field is the plain MLP."""
    opts = OPTIONS[case]
    jm, p, tm = _pair(opts, dtype)
    assert not tm.fused
    dd, ad = opts.get("deformation_dim", 0), opts.get("apperance_dim", 0)
    xyz, vd, dc, ac = _inputs(300, case, dd, ad)
    view = vd if opts.get("use_view") else None
    jr, js = jm.apply(p, jnp.asarray(xyz),
                      None if view is None else jnp.asarray(view),
                      jnp.asarray(dc) if dd else None,
                      jnp.asarray(ac) if ad else None)
    with torch.no_grad():
        tr, ts = tm(torch.from_numpy(xyz),
                    None if view is None else torch.from_numpy(view),
                    torch.from_numpy(dc) if dd else None,
                    torch.from_numpy(ac) if ad else None)
        tsig = tm.get_sigma(torch.from_numpy(xyz),
                            torch.from_numpy(dc) if dd else None)
    tol = TOL[dtype]
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=tol)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=50 * tol)
    np.testing.assert_allclose(tsig.numpy(), ts.numpy(), atol=0)
    assert tr.dtype == ts.dtype == torch.float32


def test_normal_input_gradient_with_code_matches_flax():
    """nerf_normal with a deformation code (the normal loss's field),
    float32: d alpha / d xyz with the (B, dim) code the scene expands over
    a row's points."""
    opts = dict(deformation_dim=4)
    jm, p, tm = _pair(opts, "float32")
    xyz, _, dc, _ = _inputs(200, 7, 4, 0)
    jn = JN.nerf_normal(jm, p, jnp.asarray(xyz), jnp.asarray(dc))

    from animnerf_tpu_torch.models.anim_nerf import (
        AnimNeRFConfig,
        AnimNeRFModel,
    )

    scene = AnimNeRFModel(AnimNeRFConfig(deformation_dim=4, use_fine=False))
    scene.nerf.load_state_dict(tm.state_dict())
    tn = scene.query_normal(torch.from_numpy(xyz),
                            deformation_code=torch.from_numpy(dc[:, 0]))
    # the scene expands a (B, dim) code over the points: same code per row
    jn2 = JN.nerf_normal(jm, p, jnp.asarray(xyz),
                         jnp.broadcast_to(jnp.asarray(dc[:, :1]), dc.shape))
    np.testing.assert_allclose(tn.detach().numpy(), np.asarray(jn2),
                               atol=1e-5, rtol=1e-4)
    assert np.abs(np.asarray(jn) - np.asarray(jn2)).max() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_derf_matches_flax(dtype):
    jm = JN.DeRFMLP(freqs_xyz=10, deformation_dim=6,
                    compute_dtype=jnp.dtype(dtype))
    p = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, 3)), jnp.zeros((1, 6)))
    tm = TN.DeRFMLP(10, 6, dtype)
    tm.load_state_dict(net_params_from_flax(
        "derf", jax.tree.map(np.asarray, p)))
    xyz, _, dc, _ = _inputs(300, 9, 6, 0)
    jo = jm.apply(p, jnp.asarray(xyz), jnp.asarray(dc))
    with torch.no_grad():
        to = tm(torch.from_numpy(xyz), torch.from_numpy(dc))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                               atol=TOL[dtype] * 10)
    assert to.shape == (2, 300, 9) and to.dtype == torch.float32


def test_rotation_from_ortho6d_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 7, 6)).astype(np.float32)
    want = np.asarray(JN.rotation_from_ortho6d(jnp.asarray(x)))
    got = TN.rotation_from_ortho6d(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    eye = np.einsum("...ji,...jk->...ik", got, got)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape),
                               atol=1e-5)


def test_apply_deformation_matches_jax():
    """DeRF's rigid motion with the identity blend where invalid: values,
    and the gradients in the points, the code and DeRF's weights."""
    from animnerf_tpu.models.anim_nerf import AnimNeRFConfig as JC
    from animnerf_tpu.models.anim_nerf import AnimNeRFModel as JM
    from animnerf_tpu_torch.models.anim_nerf import AnimNeRFConfig as TC
    from animnerf_tpu_torch.models.anim_nerf import AnimNeRFModel as TM

    jm = JM(JC(use_deformation=True, deformation_dim=4))
    p = jm.init(jax.random.PRNGKey(0))
    tm = TM(TC(use_deformation=True, deformation_dim=4))
    tm.derf.load_state_dict(net_params_from_flax(
        "derf", jax.tree.map(np.asarray, p["derf"])))
    rng = np.random.default_rng(0)
    xyz = rng.normal(scale=0.3, size=(2, 50, 3)).astype(np.float32)
    code = rng.normal(scale=0.1, size=(2, 4)).astype(np.float32)
    valid = (rng.uniform(size=(2, 50, 1)) > 0.3).astype(np.float32)
    ct = rng.normal(size=(2, 50, 3)).astype(np.float32)

    def f(p, x, c):
        return jnp.sum(jm.apply_deformation(p, x, jnp.asarray(valid), c)
                       * ct)

    jv = jm.apply_deformation(p, jnp.asarray(xyz), jnp.asarray(valid),
                              jnp.asarray(code))
    gp, gx, gc = jax.grad(f, argnums=(0, 1, 2))(p, jnp.asarray(xyz),
                                                jnp.asarray(code))
    x = torch.from_numpy(xyz).requires_grad_()
    c = torch.from_numpy(code).requires_grad_()
    tv = tm.apply_deformation(x, torch.from_numpy(valid), c)
    (tv * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(gc), rtol=1e-4,
                               atol=1e-4)
    want = net_params_from_flax("derf", jax.tree.map(np.asarray,
                                                     gp["derf"]))
    for name, q in tm.derf.named_parameters():
        np.testing.assert_allclose(q.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_fused_mlp_rule_follows_jax():
    """Kernel 3 exactly for the flagship architecture (JAX
    anim_nerf.py:131-145), the plain MLP for view / codes / DeRF and with
    fused_mlp "off"; the rows path needs it, unposing and no view warp."""
    from animnerf_tpu_torch.models.anim_nerf import (
        AnimNeRFConfig,
        AnimNeRFModel,
    )

    def scene(**kw):
        return AnimNeRFModel(AnimNeRFConfig(**kw))

    flagship = scene()
    assert flagship.use_fused_mlp and flagship.nerf.fused
    assert flagship.nerf_fine.fused and flagship.rows_path_ok
    for kw in (dict(use_view=True), dict(deformation_dim=2),
               dict(apperance_dim=2), dict(use_deformation=True),
               dict(fused_mlp="off")):
        s = scene(**kw)
        assert not s.use_fused_mlp and not s.nerf.fused, kw
        assert not s.rows_path_ok, kw
    assert scene(use_deformation=True).derf is not None
    s = scene(unpose_view=True)
    assert s.use_fused_mlp and not s.rows_path_ok
    s = scene(use_unpose=False)
    assert s.use_fused_mlp and not s.rows_path_ok
    assert scene(share_fine=True).nerf_fine is None
    with pytest.raises(ValueError, match="flagship"):
        TN.NeRFMLP(10, use_view=True, fused=True)


def test_remat_gives_the_same_gradients():
    """remat recomputes the plain MLP in the backward
    (torch.utils.checkpoint): the same values and gradients."""
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        m = TN.NeRFMLP(6, use_view=True, remat=remat)
        xyz, vd, _, _ = _inputs(64, 1, 0, 0)
        rgb, sigma = m(torch.from_numpy(xyz), torch.from_numpy(vd))
        (rgb.sum() + sigma.sum()).backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
