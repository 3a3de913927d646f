"""The port's post-training entry points against the JAX package's, on the
CPU: ``resolve_cfg``, ``Renderer.query_sigma_observed`` and the novel
view, novel pose and mesh extraction CLIs, all on one checkpoint that
JAX ``fit`` trains for 3 steps on a tiny synthetic dataset (as
``tests/test_cli.py`` does); the port loads the same ``last``."""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from animnerf_tpu.config import finalize as jax_finalize
from animnerf_tpu.config import get_default_config as jax_default_config
from animnerf_tpu.data.synthetic import write_synthetic_dataset
from animnerf_tpu_torch.cli import common

torch.set_num_threads(1)

N_GRID = 24


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(JAX cfg, the ``last`` checkpoint, tmp dir) after 3 JAX ``fit``
    steps on a 2-frame 20x20 dataset of a 160-vertex, 8-joint rig."""
    from animnerf_tpu.training.loop import fit

    tmp = tmp_path_factory.mktemp("cli")
    root = str(tmp / "data")
    write_synthetic_dataset(root, num_frames=2, img_wh=(20, 20),
                            num_verts=160, num_joints=8, seed=5)
    cfg = jax_default_config()
    cfg.root_dir = root
    cfg.model_path = os.path.join(root, "models")
    cfg.gender = "neutral"
    cfg.exp_name = "cli-tiny"
    cfg.img_wh = (20, 20)
    cfg.n_samples = 6
    cfg.n_importance = 3
    cfg.pose_dim = 21
    cfg.checkpoints_dir = str(tmp / "ckpts")
    cfg.logs_dir = str(tmp / "logs")
    cfg.outputs_dir = str(tmp / "out")
    for split, (s, e) in (("train", (1, 2)), ("val", (1, 1)),
                          ("test", (2, 2))):
        cfg[split].frame_start_ID = s
        cfg[split].frame_end_ID = e
        cfg[split].frame_skip = 1
        cfg[split].cam_IDs = [0]
    cfg.train.batch_size = 2
    cfg.train.subsamplesize = 5
    cfg.train.max_epochs = 1
    cfg.train.max_steps = 3
    cfg.train.log_every = 1
    cfg = jax_finalize(cfg)
    ckpt_dir = fit(cfg)
    return cfg, os.path.join(ckpt_dir, "last"), str(tmp)


def _out_opts(tmp, who):
    """Options sending a CLI's outputs to a tree of its own."""
    return ["outputs_dir", os.path.join(tmp, f"out_{who}")]


def _run_both(trained, module, args):
    """The JAX CLI and the port's (``--device cpu``) with the same
    arguments -> (JAX output dir, port output dir)."""
    import importlib

    cfg, ckpt, tmp = trained
    jax_main = importlib.import_module(f"animnerf_tpu.cli.{module}").main
    port_main = importlib.import_module(
        f"animnerf_tpu_torch.cli.{module}").main
    base = ["--ckpt_path", ckpt, *args]
    jax_main(base + _out_opts(tmp, "jax"))
    mine = port_main(base[:2] + ["--device", "cpu"] + base[2:]
                     + _out_opts(tmp, "port"))
    theirs = mine.replace(os.path.join(tmp, "out_port"),
                          os.path.join(tmp, "out_jax"))
    assert os.path.isdir(theirs), theirs
    return theirs, mine


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB")).astype(np.int32)


def psnr_u8(a, b) -> float:
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def assert_pngs_close(dir_a, dir_b, sub, why):
    """Every PNG of ``sub``: max difference <= 1 level of 255, else PSNR
    >= 60 dB (``why`` names the cause)."""
    names = sorted(os.listdir(os.path.join(dir_a, sub)))
    assert names and names == sorted(os.listdir(os.path.join(dir_b, sub)))
    for n in names:
        a = _png(os.path.join(dir_a, sub, n))
        b = _png(os.path.join(dir_b, sub, n))
        assert a.shape == b.shape
        if np.abs(a - b).max() > 1:
            assert psnr_u8(a, b) >= 60.0, (sub, n, psnr_u8(a, b), why)


# --------------------------------------------------------------- config


def test_resolve_cfg_matches_jax(trained, tmp_path):
    """With meta.json the checkpoint's config, then the YAML file, then
    the options; a bare parameter directory (no meta.json) relies on
    --cfg_file; both packages resolve the same values. Neither package's
    load_params reads a checkpoint without meta.json."""
    import yaml

    from animnerf_tpu.cli.common import resolve_cfg as jax_resolve
    from animnerf_tpu.training.checkpoints import load_params as jax_load
    from animnerf_tpu_torch.training.checkpoints import load_params
    from animnerf_tpu_torch.training.loop import build_system

    cfg, ckpt, tmp = trained
    keys = ("root_dir", "img_wh", "n_samples", "n_importance", "pose_dim",
            "exp_name", "frame_IDs", "num_frames", "dis_threshold")

    def same(a, b):
        for k in keys:
            assert list(np.atleast_1d(a[k])) == list(np.atleast_1d(b[k])), k

    yml = tmp_path / "over.yaml"
    yml.write_text(yaml.safe_dump({"n_samples": 9, "exp_name": "y"}))
    for args in ((ckpt, None, None), (ckpt, str(yml), None),
                 (ckpt, str(yml), ["n_importance", "5"])):
        got, want = common.resolve_cfg(*args), jax_resolve(*args)
        same(got, want)
    assert got.n_samples == 9 and got.n_importance == 5

    bare = tmp_path / "bare"
    bare.mkdir()
    for name in ("anim_nerf.npz", "body_params.npz"):
        shutil.copy(os.path.join(ckpt, name), bare / name)
    full = tmp_path / "full.yaml"
    full.write_text(yaml.safe_dump({
        k: (list(v) if isinstance(v, tuple) else v)
        for k, v in cfg.items() if k in ("root_dir", "model_path", "gender",
                                         "img_wh", "n_samples",
                                         "n_importance", "pose_dim")}))
    got, want = (common.resolve_cfg(str(bare), str(full)),
                 jax_resolve(str(bare), str(full)))
    same(got, want)
    assert got.n_samples == 6 and got.pose_dim == 21
    bare_default = common.resolve_cfg(str(bare), None)
    assert bare_default.n_samples == jax_resolve(str(bare), None).n_samples
    with pytest.raises(FileNotFoundError):
        common.resolve_cfg(str(tmp_path / "missing"), str(full))
    with pytest.raises(FileNotFoundError):
        jax_load(str(bare), {})
    with pytest.raises(FileNotFoundError):
        load_params(str(bare), build_system(got, "cpu"))


# ---------------------------------------------------------- sigma grid


def _jax_sigma(trained, points):
    from animnerf_tpu.cli.common import (
        load_frame_params,
        load_system_and_params,
        optimized_frame_params,
    )
    from animnerf_tpu.render.inference import Renderer

    cfg, ckpt, _ = trained
    system, params = load_system_and_params(cfg, ckpt)
    frame_idx, bp, tmpl = load_frame_params(cfg, 1)
    bp = optimized_frame_params(cfg, params, frame_idx, bp)
    return Renderer(system).query_sigma_observed(params, bp, tmpl, points,
                                                 use_fine=True)


def _port_setup(trained):
    from animnerf_tpu_torch.render.inference import Renderer

    cfg, ckpt, _ = trained
    pcfg = common.resolve_cfg(ckpt)
    system = common.load_system_and_params(pcfg, ckpt, "cpu")
    frame_idx, bp, tmpl = common.load_frame_params(pcfg, 1, "cpu")
    bp = common.optimized_frame_params(pcfg, system, frame_idx, bp)
    return system, Renderer(system, device="cpu"), bp, tmpl


def _grid_points(renderer, bp, tmpl):
    """The mesh CLI's 24^3 grid about the body's centre (1, N^3, 3)."""
    from animnerf_tpu_torch.cli.extract_mesh import create_grid
    from animnerf_tpu_torch.models.warp import prepare_frame

    with torch.no_grad():
        verts = prepare_frame(renderer.system.body_model, bp,
                              tmpl).verts[0].numpy()
    center = (verts.max(0) + verts.min(0)) / 2.0
    grid = create_grid(N_GRID, [-1.2, 1.2], [-1.2, 1.2], [-1.2, 1.2])
    return grid.reshape(1, -1, 3).astype(np.float32) + center


def test_query_sigma_observed_matches_jax(trained):
    """relu(sigma) on the 24^3 grid of the mesh CLI, f32: within 1e-4 x
    (1 + |sigma|) of JAX's; small chunks (many device-side chunks, one
    copy) give the same grid; with knn_far_skip on, bit-equal to off."""
    system, renderer, bp, tmpl = _port_setup(trained)
    pts = _grid_points(renderer, bp, tmpl)
    got = renderer.query_sigma_observed(bp, tmpl, pts)
    want = np.asarray(_jax_sigma(trained, pts))
    assert got.shape == want.shape == (1, N_GRID**3, 1)
    assert got.dtype == np.float32
    assert (want > 0).mean() > 0.01  # the body is in the grid
    assert np.all(np.abs(got - want) <= 1e-4 * (1 + np.abs(want)))
    np.testing.assert_array_equal(
        renderer.query_sigma_observed(bp, tmpl, pts, chunk=1000), got)
    system.scene_cfg = dataclasses.replace(system.scene_cfg,
                                           knn_far_skip=True)
    system.scene.cfg = system.scene_cfg
    np.testing.assert_array_equal(
        renderer.query_sigma_observed(bp, tmpl, pts), got)


def test_marching_on_the_sigma_grid_bit_equal_to_jax(trained):
    """The mesh CLI's field from JAX's sigma grid (relu, threshold,
    smooth, negated): both marchings of both packages bit for bit."""
    from animnerf_tpu.ops import marching as jax_mc
    from animnerf_tpu_torch.ops import marching as mc

    _, renderer, bp, tmpl = _port_setup(trained)
    sig = np.asarray(_jax_sigma(trained, _grid_points(renderer, bp, tmpl)))
    sig = np.maximum(sig.reshape(N_GRID, N_GRID, N_GRID), 0)
    thr = float(np.quantile(sig[sig > 0], 0.5))
    field = -mc.smooth(sig - thr)
    np.testing.assert_array_equal(field, -jax_mc.smooth(sig - thr))
    for fn in ("marching_tets_native", "marching_tets_numpy"):
        v, t = getattr(mc, fn)(field, 0.0)
        jv, jt = getattr(jax_mc, fn)(field, 0.0)
        assert len(t) > 20, fn
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(t, jt)


# ------------------------------------------------------------------ CLIs


def test_extract_mesh_matches_jax(trained):
    """--N_grid 24 at a threshold that cuts a surface: smpl.obj within
    1e-5, mesh.obj's vertex count within 1% and the symmetric largest
    nearest-vertex distance within one grid cell (2.4 / N)."""
    from scipy.spatial import cKDTree

    from animnerf_tpu_torch.utils.io import load_obj

    _, renderer, bp, tmpl = _port_setup(trained)
    sig = np.asarray(_jax_sigma(trained, _grid_points(renderer, bp, tmpl)))
    thr = float(np.quantile(sig[sig > 0], 0.5))
    jdir, pdir = _run_both(trained, "extract_mesh", [
        "--N_grid", str(N_GRID), "--sigma_threshold", repr(thr)])
    jv, jf = load_obj(os.path.join(jdir, "smpl.obj"))
    pv, pf = load_obj(os.path.join(pdir, "smpl.obj"))
    np.testing.assert_allclose(pv, jv, atol=1e-5)
    np.testing.assert_array_equal(pf, jf)
    jv, jf = load_obj(os.path.join(jdir, "mesh.obj"))
    pv, pf = load_obj(os.path.join(pdir, "mesh.obj"))
    assert len(jv) > 20
    assert abs(len(pv) - len(jv)) <= 0.01 * len(jv)
    cell = 2.4 / N_GRID
    d_pj = cKDTree(jv).query(pv)[0].max()
    d_jp = cKDTree(pv).query(jv)[0].max()
    assert max(d_pj, d_jp) <= cell, (d_pj, d_jp, cell)


@pytest.mark.parametrize("args", [
    ["--n_views", "2", "--betas_2th", "0.3"],
    ["--n_views", "1", "--template", "--orig_pose"],
], ids=["betas_2th", "template_orig_pose"])
def test_novel_view_matches_jax(trained, args):
    """The decoded images and depths PNGs: within 1 level of 255, else
    >= 60 dB. Cause of a larger difference: the depth map is colourised
    after normalising by its own min and max, so a last-bit difference of
    the f32 composite can move a pixel across a JET bin edge."""
    jdir, pdir = _run_both(trained, "novel_view", args)
    for sub in ("images", "depths"):
        assert_pngs_close(jdir, pdir, sub, "f32 rounding of the composite "
                          "moved across a quantisation step")
    assert os.path.getsize(os.path.join(pdir, "novel_view.gif")) > 0


def test_novel_pose_matches_jax(trained):
    """A seeded 2-frame mocap: images and masks as the novel views;
    smpls_vis (the body model's vertices rastered) with at most 0.1% of
    pixels differing: the two body models round their last bits
    differently, so a pixel on a triangle's edge can flip."""
    _, _, tmp = trained
    actions = os.path.join(tmp, "mocap")
    os.makedirs(os.path.join(actions, "0007"), exist_ok=True)
    rng = np.random.default_rng(0)
    F = 2
    with open(os.path.join(actions, "0007", "result.pkl"), "wb") as f:
        pickle.dump({
            "anim_len": F,
            "smpl_array": rng.normal(scale=0.1, size=(F, 72)).astype(
                np.float32),
            "cam_array": rng.normal(scale=0.1, size=(F, 4)).astype(
                np.float32),
        }, f)
    jdir, pdir = _run_both(trained, "novel_pose", [
        "--actions_dir", actions, "--action_type", "0007",
        "--frame_skip", "1"])
    for sub in ("images", "masks"):
        assert_pngs_close(jdir, pdir, sub, "f32 rounding of the composite")
    names = sorted(os.listdir(os.path.join(jdir, "smpls_vis")))
    assert len(names) == F
    for n in names:
        a = _png(os.path.join(jdir, "smpls_vis", n))
        b = _png(os.path.join(pdir, "smpls_vis", n))
        assert (a != 255).any()  # the body is in view
        assert (a != b).any(-1).mean() <= 1e-3
    assert os.path.getsize(os.path.join(pdir, "novel_pose.gif")) > 0


@pytest.mark.parametrize("module, extra", [
    ("novel_view", ["--n_views", "1"]),
    ("novel_pose", ["--actions_dir", "nowhere"]),
    ("extract_mesh", ["--N_grid", "8"]),
])
def test_clis_need_cuda_unless_cpu_is_asked(trained, monkeypatch, module,
                                            extra):
    import importlib

    _, ckpt, _ = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"animnerf_tpu_torch.cli.{module}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--ckpt_path", ckpt, *extra])
