"""The port's point-major compacted training step (``compact_loss_fn``,
``CompactTrainer``), the engine switch (``make_trainer(engine=)``,
``ANIMNERF_TRAINER``) and ``ANIMNERF_KNN_PACKED=0``, on the CPU.

The JAX twin runs ``AnimNeRFSystem.compact_loss_fn`` at full capacity on
``tests/test_parallel.py``'s tiny flagship setup with its kernels in
interpret mode (``rows_path_forced``, the fused MLP on, and the kNN
dispatcher sent to ``knn_pallas`` as on the TPU, so both sides take the
packed-key kNN); the port runs the kernels' plain versions from the same
parameters and the same noise (``test_torch_train.py``'s helpers).
"""

from __future__ import annotations

import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_parallel import _tiny_setup  # noqa: E402
from test_rows_pipeline import rows_path_forced  # noqa: E402
from test_torch_train import (  # noqa: E402
    B,
    KEY,
    R,
    check_details,
    check_grads,
    jax_noise,
    port_system,
)

from animnerf_tpu.models.body_params import init_body_params  # noqa: E402
from animnerf_tpu_torch.training import system as TS  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref():
    """One JAX value-and-grad of compact_loss_fn, its config, batch,
    parameters and noise."""
    import animnerf_tpu.ops.knn as JK

    cfg, system, nj, batch = _tiny_setup(seed=0, B=B, n_rays=R)
    state = system.init_state(
        jax.random.PRNGKey(0),
        init_body_params(cfg.num_frames, pose_dim=3 * (nj - 1)),
        steps_per_epoch=10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    on_tpu = JK._on_tpu
    JK._on_tpu = lambda: True
    try:
        with rows_path_forced():
            system.scene.__dict__["use_fused_mlp"] = True
            (_, details), grads = jax.value_and_grad(
                partial(system.compact_loss_fn, cap_c=R * cfg.n_samples),
                has_aux=True)(state.params, jb, jax.random.PRNGKey(KEY),
                              state.step)
    finally:
        JK._on_tpu = on_tpu
    jax.clear_caches()
    noise = jax_noise(jax.random.PRNGKey(KEY), 0, B, R, cfg.n_samples,
                      cfg.n_importance, 128)
    return dict(cfg=cfg, nj=nj, batch=batch, params=state.params,
                details=jax.tree.map(np.asarray, details),
                grads=jax.tree.map(np.asarray, grads), noise=noise,
                rigid_lbs=False)


def _batch(ref):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in
            ref["batch"].items()}


def _grads(system):
    return {k: p.grad.detach().clone() for k, p in system.named_parameters()
            if p.grad is not None}


def port_loss(ref, loss_fn, cfg=None, noise=None):
    """(details, grads by parameter name) of the port's ``loss_fn`` from
    the reference's parameters, batch and noise."""
    system = port_system(cfg if cfg is not None else ref["cfg"], ref["nj"],
                         ref["params"])
    loss, details = loss_fn(system, _batch(ref),
                            noise if noise is not None else ref["noise"])
    loss.backward()
    return system, details


@pytest.fixture(scope="module")
def port(ref):
    return port_loss(ref, TS.compact_loss_fn)


def test_compact_details_match_jax(ref, port):
    """Every details entry of JAX's compact_loss_fn, at the bounds of
    test_torch_train.py (rtol 1e-5; 2e-3 for the normal terms and the
    total), the survivor count equal, no overflow on either side."""
    check_details(ref, port)
    assert port[1]["compact_overflow"] == 0


def test_compact_grads_match_jax(ref, port):
    """Every gradient leaf within test_torch_train.py's hybrid rel-L2
    bound (2e-3, or 1e-8 absolute)."""
    check_grads(ref, port)


# The port's compacted loss against its dense loss (the rows render on
# the flagship) on one batch and noise. They differ in the kNN's vertex
# order (mesh order against the Morton order of the rows path: the packed
# keys break near-ties by index) and in summation layouts (point-major
# against channel-leading composites), so they are not bit-equal; the
# measured spread is ~1e-7 relative on the loss terms and ~1e-6 rel-L2 on
# the gradients, held here to 1e-5 and 1e-4.
DENSE_LOSS_RTOL = 1e-5
DENSE_GRAD_REL_L2 = 1e-4


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    den = float(b.norm())
    return float((a - b).norm()) / den if den > 0 else float((a - b).norm())


def _compare_engines(ref, cfg=None, noise=None):
    dense_sys, dd = port_loss(ref, TS.loss_fn, cfg, noise)
    comp_sys, cd = port_loss(ref, TS.compact_loss_fn, cfg, noise)
    assert set(dd) <= set(cd)
    for k, v in dd.items():
        np.testing.assert_allclose(float(cd[k].detach()), float(v.detach()),
                                   rtol=DENSE_LOSS_RTOL, err_msg=k)
    gd, gc = _grads(dense_sys), _grads(comp_sys)
    assert sorted(gd) == sorted(gc)
    worst = max(_rel_l2(gc[k], gd[k]) for k in gd)
    assert worst <= DENSE_GRAD_REL_L2, worst
    return cd


def test_compact_loss_matches_the_ports_dense_loss(ref):
    """compact_loss_fn against loss_fn (the dense rows render) on the same
    batch and noise: loss terms within DENSE_LOSS_RTOL, every gradient
    within DENSE_GRAD_REL_L2 rel-L2."""
    d = _compare_engines(ref)
    assert 0 < d["compact_count"] <= R * ref["cfg"].n_samples


def test_coarse_only_compact_matches_dense(ref):
    """n_fine = 0 (no fine field): the compacted step returns after the
    coarse composite, and still matches the dense loss and gradients."""
    cfg = ref["cfg"].clone()
    cfg.n_importance = 0
    noise = ref["noise"]
    noise = type(noise)(**{**noise.__dict__,
                           "fine_u": noise.fine_u[..., :0],
                           "sigma_f": noise.sigma_f[..., :cfg.n_samples]})
    d = _compare_engines(ref, cfg, noise)
    assert "loss_rgb_fine" not in d


def test_compact_trainer_raises_where_compaction_is_inexact(ref):
    """DeRF, latent codes or no unposing: ValueError, as JAX's
    CompactTrainer raises (training/system.py:613-619); make_trainer with
    engine="compact" raises the same, "rows" on a config off the rows
    pipeline too."""
    for over in ({"use_deformation": True}, {"deformation_dim": 8},
                 {"use_unpose": False}):
        cfg = ref["cfg"].clone()
        for k, v in over.items():
            setattr(cfg, k, v)
        system = _bare_system(cfg, ref["nj"])
        assert not TS.compaction_applicable(system)
        with pytest.raises(ValueError, match="compact"):
            TS.CompactTrainer(system)
        with pytest.raises(ValueError, match="compact"):
            TS.make_trainer(system, engine="compact")
        with pytest.raises(ValueError, match="rows"):
            TS.make_trainer(system, engine="rows")
        assert TS.make_trainer(system, engine="auto").engine == "dense"
    with pytest.raises(ValueError, match="unknown trainer engine"):
        TS.make_trainer(port_system(ref["cfg"], ref["nj"], ref["params"]),
                        engine="fast")


def _bare_system(cfg, nj):
    """The tiny rig's system at its seeded initial parameters."""
    from animnerf_tpu_torch.data.synthetic import make_body_model
    from animnerf_tpu_torch.system import AnimNeRFSystem

    return AnimNeRFSystem(dict(cfg, pose_dim=3 * (nj - 1)),
                          make_body_model(128, nj, seed=0), device="cpu")


@pytest.mark.parametrize("env,engine", [
    (None, "rows"), ("auto", "rows"), ("rows", "rows"),
    ("compact", "compact"), ("dense", "dense")])
def test_animnerf_trainer_selects_the_engine(ref, monkeypatch, env, engine):
    """make_trainer(engine=None) reads ANIMNERF_TRAINER (default auto, the
    rows engine on the flagship); an explicit engine wins over it."""
    if env is None:
        monkeypatch.delenv("ANIMNERF_TRAINER", raising=False)
    else:
        monkeypatch.setenv("ANIMNERF_TRAINER", env)
    system = port_system(ref["cfg"], ref["nj"], ref["params"])
    trainer = TS.make_trainer(system, steps_per_epoch=10)
    assert trainer.engine == engine
    assert type(trainer) is TS.ENGINES[engine]
    assert TS.make_trainer(system, engine="dense").engine == "dense"


def test_compact_trainer_step(ref, monkeypatch):
    """One CompactTrainer step through make_trainer under
    ANIMNERF_TRAINER=compact: the exact survivor count, overflow 0,
    finite loss and gradients, the parameters move."""
    monkeypatch.setenv("ANIMNERF_TRAINER", "compact")
    system = port_system(ref["cfg"], ref["nj"], ref["params"])
    before = system.scene.nerf.xyz_0.weight.detach().clone()
    trainer = TS.make_trainer(system, steps_per_epoch=10)
    d = trainer.step(_batch(ref), ref["noise"])
    assert d["compact_count"] == int(ref["details"]["compact_count"])
    assert d["compact_overflow"] == 0 and torch.isfinite(d["loss"])
    assert all(torch.isfinite(p.grad).all() for p in system.parameters()
               if p.grad is not None)
    assert not torch.equal(before, system.scene.nerf.xyz_0.weight)


def _grid_cloud(V=700, N=1500, seed=3):
    """Vertices and points on a 1/64 grid (XLA:CPU's FMA contraction of
    the interpret-mode d2 then changes no rounding)."""
    rng = np.random.default_rng(seed)
    verts = np.round(rng.normal(scale=0.3, size=(1, V, 3)) * 64) / 64
    pts = np.round((verts[:, rng.integers(0, V, N)]
                    + rng.normal(scale=0.05, size=(1, N, 3))) * 64) / 64
    return pts.astype(np.float32), verts.astype(np.float32)


def _spy(monkeypatch, module, names):
    """Wrap module's functions ``names`` to record their calls by name."""
    calls = []
    for name in names:
        fn = getattr(module, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("k", [4, 8])
def test_knn_packed_off_takes_the_exact_kernel(monkeypatch, k):
    """ANIMNERF_KNN_PACKED=0: the port's knn dispatch takes kernel 9
    (``knn_exact``) at V <= 8192, where it takes kernel 1 / 8 by default,
    and its output is bit-equal to JAX's knn_pallas(packed=False) in
    interpret mode; unset, the dispatch takes the packed keys again."""
    from animnerf_tpu.ops.knn_pallas import knn_pallas
    from animnerf_tpu_torch.ops import knn_kernel as KK

    pts, verts = _grid_cloud()
    tp, tv = torch.from_numpy(pts), torch.from_numpy(verts)
    calls = _spy(monkeypatch, KK, ("knn_top4", "knn_packed", "knn_exact"))
    monkeypatch.setenv("ANIMNERF_KNN_PACKED", "0")
    d, i = KK.knn(tp, tv, k, tile_skip=True)
    assert calls == ["knn_exact"]
    de, ie = KK.knn_exact_plain(tp, tv, k)
    assert torch.equal(d, de) and torch.equal(i, ie)
    dj, ij = knn_pallas(jnp.asarray(pts), jnp.asarray(verts), k=k,
                        packed=False, transposed_out=True, interpret=True)
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    monkeypatch.delenv("ANIMNERF_KNN_PACKED")
    KK.knn(tp, tv, k)
    assert calls[1:] == ["knn_top4" if k == 4 else "knn_packed"]


def test_knn_packed_off_reaches_every_caller(ref, monkeypatch):
    """Under ANIMNERF_KNN_PACKED=0 every kNN of the compacted and the dense
    loss (warp_knn, unpose, the rows path) goes to the exact kNN, and the
    two losses still agree."""
    from animnerf_tpu_torch.ops import knn_kernel as KK

    monkeypatch.setenv("ANIMNERF_KNN_PACKED", "0")
    calls = _spy(monkeypatch, KK, ("knn_top4", "knn_packed", "knn_exact"))
    _compare_engines(ref)
    assert calls and set(calls) == {"knn_exact"}


def test_cli_train_under_animnerf_trainer_compact(tmp_path, monkeypatch,
                                                  capsys):
    """ANIMNERF_TRAINER=compact cli.train: fit takes the point-major
    compacted step (it prints the engine), trains two steps on a tiny
    synthetic dataset on the CPU with finite losses, writes ``last`` and
    evaluates it."""
    from animnerf_tpu_torch.cli import train as cli_train
    from animnerf_tpu_torch.data.synthetic import write_synthetic_dataset

    root = str(tmp_path / "ds")
    write_synthetic_dataset(root, num_frames=3, img_wh=(16, 16),
                            num_verts=128, num_joints=8, seed=7)
    monkeypatch.setenv("ANIMNERF_TRAINER", "compact")
    cli_train.main([
        "--device", "cpu", "root_dir", root,
        "model_path", os.path.join(root, "models"), "gender", "neutral",
        "n_samples", "8", "n_importance", "4", "freqs_xyz", "4",
        "img_wh", "(16,16)", "exp_name", "compact",
        "checkpoints_dir", str(tmp_path / "ck"),
        "logs_dir", str(tmp_path / "lg"),
        "train.frame_start_ID", "1", "train.frame_end_ID", "2",
        "train.frame_skip", "1", "train.subsamplesize", "4",
        "train.batch_size", "2", "train.max_steps", "2",
        "train.log_every", "1", "val.frame_start_ID", "3",
        "val.frame_end_ID", "3", "val.frame_skip", "1",
        "test.frame_start_ID", "3", "test.frame_end_ID", "3",
        "test.frame_skip", "1"])
    out = capsys.readouterr().out
    assert "trainer engine: compact" in out
    losses = [float(line.split(" loss ")[1].split()[0])
              for line in out.splitlines() if " loss " in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "mean psnr" in out
    assert os.path.isfile(tmp_path / "ck" / "compact" / "last"
                          / "anim_nerf.npz")
