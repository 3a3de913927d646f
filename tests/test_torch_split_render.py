"""The reference's other field options against the JAX package on the CPU:
``AnimNeRFSystem.render`` (perturb 0) and the dense training loss
``loss_fn`` (values and gradients, JAX's noise passed in), one case per
option (``CASES``): view directions and view directions warped with the
points (``unpose_view``) here; latent codes + DeRF (with ``frame_idx``)
and a shared fine field in ``test_torch_split_codes.py``; depth-guided
samples (``n_depth``), more than 128 samples a ray and no unposing in
``test_torch_split_samples.py`` (three files, so that each runs in about
a minute on one core; ``check_render`` and ``check_loss`` are shared).

``tests/test_parallel.py``'s tiny rig (V=128, J=12, 2 x 16 rays), its
fields at random weights with the sigma heads' biases raised by 30 so
that the 0.2 m shell is opaque, as a trained body is (see
``tests/test_torch_dense_render.py``). The JAX package renders every
case with ``render_rays_split``, its TPU warp (the packed kNN and the
warp-blend kernel, ``warp_view`` included) in interpret mode
(``rows_interpret_forced``) and its flax MLP; the port takes the route
its own ``rows_renderable`` picks (the rows path for ``n_depth`` and
``share_fine``, which the JAX package takes on the TPU with its fused
MLP, the split path for the others) on its kernels' plain versions. The
kNN must be the same algorithm on both sides: the JAX package's plain
XLA kNN breaks near-ties of the packed keys otherwise, which moves a
sample's canonical point by centimetres. The noise is drawn with
``jax.random`` along the JAX key path and passed in.

The fields encode 4 frequencies (``freqs_xyz`` 4, the chip script runs
10): the gradients through the warp carry the field's second derivative
in the canonical point, which at 2^9 and random weights under the opaque
shell is so large that the f32 rounding of a canonical point (~1e-7)
moves the body params' gradients by 2-5%, between any two
implementations: the JAX package's own step jitted and run op by op
differ by that much there.

Tolerances (float32): outputs atol 1e-4, depths 5e-4 (depth ~ 3 x
alpha); loss terms rtol 1e-5, the normal terms and the total 2e-3 (see
``tests/test_torch_train.py``); every gradient leaf the hybrid rel-L2
bound 2e-3 of the JAX package's compacted-vs-dense test.
"""

from __future__ import annotations

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_parallel import _tiny_setup  # noqa: E402
from test_torch_train import _rel_l2_ok  # noqa: E402

from animnerf_tpu.models.body_params import init_body_params  # noqa: E402
from animnerf_tpu.utils import rng as prng  # noqa: E402
from animnerf_tpu.utils.interpret import rows_interpret_forced  # noqa: E402
from animnerf_tpu_torch.data.synthetic import make_body_model  # noqa: E402
from animnerf_tpu_torch.system import AnimNeRFSystem  # noqa: E402
from animnerf_tpu_torch.training import system as TS  # noqa: E402
from animnerf_tpu_torch.utils.convert import (  # noqa: E402
    net_params_from_flax,
    params_from_jax,
)
from animnerf_tpu_torch.utils.rng import TrainNoise  # noqa: E402

torch.set_num_threads(1)

B, R = 2, 16
KEY = 7
ATOL = 1e-4
# the encoding's frequencies (the module docstring says why not 10)
FREQS_XYZ = 4

CASES = {
    "view": dict(use_view=True, freqs_dir=4),
    "view_unpose": dict(use_view=True, freqs_dir=4, unpose_view=True),
    "codes_derf": dict(use_deformation=True, deformation_dim=4,
                       apperance_dim=3),
    "n_depth": dict(n_depth=4),
    "share_fine": dict(share_fine=True),
    "wide": dict(n_samples=100, n_importance=40),
    "no_unpose": dict(use_unpose=False),
}


def jax_noise(keys, B, R, Kc, Kf, Kd, V) -> TrainNoise:
    """The split path's draws along the JAX key path: keys -> (k_render,
    k_loss); k_render -> (coarse, fine, sigma_c, sigma_f, depth); k_loss
    -> the two normal-loss jitters."""
    k_render, k_loss = prng.split_keys(keys, 2)
    kc, kf, knc, knf, kd = prng.split_keys(k_render, 5)
    k1, k2 = prng.split_keys(k_loss, 2)

    def t(a):
        return torch.from_numpy(np.array(a))

    return TrainNoise(t(prng.uniform(kc, (B, R, Kc))),
                      t(prng.uniform(kf, (B, R, Kf))),
                      t(prng.normal(knc, (B, R, Kc))),
                      t(prng.normal(knf, (B, R, Kc + Kf + Kd))),
                      t(prng.normal(k1, (B, V, 3))),
                      t(prng.normal(k2, (B, V, 3))),
                      t(prng.normal(kd, (B, R, Kd))) if Kd else None)


def eval_noise(B, R, Kd, V) -> TrainNoise:
    """The depth-guided draws of a JAX render at perturb 0 (its default
    key 0); the other fields are unused there."""
    kd = prng.split_keys(jax.random.PRNGKey(0), 5)[4]
    z = torch.zeros(B, R, 1)
    return TrainNoise(z, z, z, z, torch.zeros(B, V, 3), torch.zeros(B, V, 3),
                      torch.from_numpy(np.array(prng.normal(kd, (B, R, Kd))))
                      if Kd else None)


@functools.lru_cache(maxsize=None)
def jax_case(name: str) -> dict:
    """The JAX render and loss of one case, with its config, batch,
    parameters, gradients and noise."""
    from animnerf_tpu.training.system import AnimNeRFSystem as JSys

    cfg, system, nj, batch = _tiny_setup(seed=0, B=B, n_rays=R)
    cfg.freqs_xyz = FREQS_XYZ
    for k, v in CASES[name].items():
        cfg[k] = v
    system = JSys(cfg, system.body_model)
    params = system.init_params(
        jax.random.PRNGKey(0),
        init_body_params(cfg.num_frames, pose_dim=3 * (nj - 1)))
    for net in ("nerf", "nerf_fine"):  # an opaque shell
        if net in params["anim_nerf"]:
            sig = params["anim_nerf"][net]["params"]["sigma"]
            sig["bias"] = sig["bias"] + 30.0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    bp = {k: jb[k] for k in params["body_params"]}
    tmpl = {k: jb[k + "_template"] for k in params["body_params"]}
    key = jax.random.PRNGKey(KEY)
    with rows_interpret_forced():
        assert not system.rows_renderable()

        def both(params, jb, key):
            out, _ = system.render(params, bp, tmpl, jb["rays"],
                                   frame_idx=jb["frame_idx"], perturb=0.0)
            return out, jax.value_and_grad(system.loss_fn, has_aux=True)(
                params, jb, key)

        out, ((_, details), grads) = jax.jit(both)(params, jb, key)
    Kd = cfg.n_depth
    noise = jax_noise(prng.elem_keys(key, B), B, R, cfg.n_samples,
                      cfg.n_importance, Kd, 128)
    res = dict(cfg=cfg, nj=nj, batch=batch,
               params=jax.tree.map(np.asarray, params),
               out=jax.tree.map(np.asarray, out),
               details=jax.tree.map(np.asarray, details),
               grads=jax.tree.map(np.asarray, grads), noise=noise,
               eval_noise=eval_noise(B, R, Kd, 128))
    jax.clear_caches()
    return res


def port_system(ref) -> AnimNeRFSystem:
    nj = ref["nj"]
    system = AnimNeRFSystem(dict(ref["cfg"], pose_dim=3 * (nj - 1)),
                            make_body_model(128, nj, seed=0), device="cpu")
    system.load_params(params_from_jax(ref["params"]))
    return system


def _t(d: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def check_render(name: str) -> None:
    """render at perturb 0, every output; the port's route is the one
    its rows_renderable picks, as the JAX package's on the TPU."""
    ref = jax_case(name)
    system = port_system(ref)
    want_rows = name in ("n_depth", "share_fine")
    assert system.rows_renderable() == want_rows
    batch = _t(ref["batch"])
    bp = {k: batch[k] for k in system.body_params}
    tmpl = {k: batch[k + "_template"] for k in system.body_params}
    with torch.no_grad():
        out, _ = system.render(bp, tmpl, batch["rays"], batch["frame_idx"],
                               noise=ref["eval_noise"])
    assert set(out) == set(ref["out"])
    for k, v in ref["out"].items():
        tol = 5 * ATOL if k.startswith("depths") else ATOL
        np.testing.assert_allclose(out[k].numpy(), v, atol=tol, err_msg=k)
    assert np.isfinite(ref["out"]["rgbs"]).all()
    # the opaque shell: some rays hit the body
    assert (ref["out"]["alphas"] > 0.5).any()


def port_loss(ref):
    system = port_system(ref)
    batch = _t(ref["batch"])
    loss, details = TS.loss_fn(system, batch, ref["noise"])
    loss.backward()
    return system, details


def check_loss(name: str) -> None:
    """The dense loss_fn: every details entry and every gradient leaf
    (the fields, DeRF, the latent codes, the body params)."""
    ref = jax_case(name)
    system, td = port_loss(ref)
    jd = ref["details"]
    assert set(td) == set(jd)
    for k, v in jd.items():
        tol = 2e-3 if k.startswith("loss_normals") or k == "loss" else 1e-5
        np.testing.assert_allclose(float(td[k].detach()), float(v),
                                   rtol=tol, atol=1e-7, err_msg=k)
    if name == "no_unpose":
        assert not any(k.startswith("loss_foreground") for k in jd)
    g = ref["grads"]
    for net, flat in g["anim_nerf"].items():
        want = net_params_from_flax(net, flat)
        for pname, p in getattr(system.scene, net).named_parameters():
            _rel_l2_ok(want[pname].numpy(), p.grad.numpy(),
                       f"{net}.{pname}")
    for k, v in g["body_params"].items():
        _rel_l2_ok(v, system.body_params[k].grad.numpy(), f"body.{k}")
    if "latent_codes" in g:
        _rel_l2_ok(g["latent_codes"], system.latent_codes.grad.numpy(),
                   "latent_codes")
        assert np.abs(g["latent_codes"]).max() > 0


HERE = ("view", "view_unpose")


@pytest.mark.parametrize("name", HERE)
def test_render_matches_jax(name):
    check_render(name)


@pytest.mark.parametrize("name", HERE)
def test_dense_loss_matches_jax(name):
    check_loss(name)
