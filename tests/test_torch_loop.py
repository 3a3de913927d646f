"""The port's training loop (``training/loop.py``) against the JAX
package's, on a synthetic dataset on disk and on the CPU: ``fit`` against
JAX ``fit`` (same initial checkpoint, SGD, the JAX noise), resume,
refinement, checkpoints read across the packages, ``evaluate`` against
JAX ``evaluate``, the TensorBoard events, and the train / test CLIs."""

from __future__ import annotations

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_rows_pipeline import rows_path_forced  # noqa: E402
from test_torch_train import jax_noise  # noqa: E402

from animnerf_tpu.config import finalize as jax_finalize  # noqa: E402
from animnerf_tpu.config import get_default_config as jax_cfg  # noqa: E402
from animnerf_tpu.data.synthetic import write_synthetic_dataset  # noqa: E402
from animnerf_tpu_torch.config import (  # noqa: E402
    finalize,
    get_default_config,
)
from animnerf_tpu_torch.training import loop as TL  # noqa: E402
from animnerf_tpu_torch.training import system as TS  # noqa: E402

torch.set_num_threads(1)

NJ, NV, SIZE = 8, 128, 16
B, SUB = 2, 4   # batch of 2 frames x 4^2 rays


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ds"))
    write_synthetic_dataset(root, num_frames=4, img_wh=(SIZE, SIZE),
                            num_verts=NV, num_joints=NJ, seed=7)
    return root


def _opts(root, out, exp, *extra):
    return ["root_dir", root, "model_path", os.path.join(root, "models"),
            "gender", "neutral", "n_samples", "8", "n_importance", "4",
            "freqs_xyz", "4", "img_wh", f"({SIZE},{SIZE})", "exp_name", exp,
            "checkpoints_dir", os.path.join(out, "ck"),
            "logs_dir", os.path.join(out, "lg"),
            "train.frame_start_ID", "1", "train.frame_end_ID", "2",
            "train.frame_skip", "1", "train.subsamplesize", str(SUB),
            "train.batch_size", str(B), "train.max_steps", "3",
            "train.log_every", "1", "val.frame_start_ID", "3",
            "val.frame_end_ID", "3", "val.frame_skip", "1",
            "test.frame_start_ID", "3", "test.frame_end_ID", "4",
            "test.frame_skip", "1", *extra]


def _port_cfg(*args):
    cfg = get_default_config()
    cfg.merge_from_list(_opts(*args))
    return finalize(cfg)


def _jax_cfg(*args):
    cfg = jax_cfg()
    cfg.merge_from_list(_opts(*args))
    return jax_finalize(cfg)


def _npz(path):
    out = {}
    for name in ("anim_nerf", "body_params"):
        with np.load(os.path.join(path, f"{name}.npz")) as d:
            out.update({f"{name}:{k}": d[k] for k in d.files})
    return out


def _jax_init_ckpt(cfg, path):
    """The JAX package's initial parameters for cfg as a checkpoint."""
    from animnerf_tpu.models.body_params import load_body_params_from_dataset
    from animnerf_tpu.training.checkpoints import save_params
    from animnerf_tpu.training.loop import build_system

    system = build_system(cfg)
    params = system.init_params(jax.random.PRNGKey(0),
                                load_body_params_from_dataset(
                                    cfg.frame_IDs, cfg.root_dir))
    save_params(path, jax.tree.map(np.asarray, params), {"step": 0})


def _logged(cfg, step):
    path = os.path.join(cfg.logs_dir, cfg.exp_name, "metrics.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if r["step"] == step and "train/loss" in r][0]


def test_fit_matches_jax_fit(root, tmp_path, monkeypatch):
    """Both load one JAX initial checkpoint (train.ckpt_path, the field
    trainable), train 3 SGD-momentum steps on the same batches with the
    same noise (the port draws it along the JAX key path
    fold_in(PRNGKey(seed + 1), step)): step 1's logged loss within rtol
    5e-5, every array of the two ``last`` checkpoints within rtol 1e-4 /
    atol 1e-6. The JAX side runs its rows-compacted trainer with its
    kernels in interpret mode."""
    init = str(tmp_path / "init")
    sgd = ["train.optimizer.type", "sgd", "train.ckpt_path", init,
           "train.pretrained_model_requires_grad", "true"]
    jcfg = _jax_cfg(root, str(tmp_path), "j", "fused_mlp", "on", *sgd)
    _jax_init_ckpt(jcfg, init)
    from animnerf_tpu.training.loop import fit as jax_fit

    monkeypatch.setenv("ANIMNERF_TRAINER", "rows")
    monkeypatch.setenv("ANIMNERF_MORTON_COMPACT", "1")
    with rows_path_forced():
        jdir = jax_fit(jcfg)
    jax.clear_caches()

    pcfg = _port_cfg(root, str(tmp_path), "p", *sgd)
    key = jax.random.PRNGKey(pcfg.seed + 1)
    monkeypatch.setattr(
        TS.RowsCompactTrainer, "draw_noise",
        lambda self, batch: jax_noise(key, self.steps, B, SUB * SUB, 8, 4,
                                      NV))
    pdir = TL.fit(pcfg, device="cpu")
    np.testing.assert_allclose(_logged(pcfg, 1)["train/loss"],
                               _logged(jcfg, 1)["train/loss"], rtol=5e-5)
    a, b = _npz(os.path.join(jdir, "last")), _npz(os.path.join(pdir, "last"))
    assert sorted(a) == sorted(b)
    init_arrays = _npz(init)
    moved = 0
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
        moved += not np.array_equal(a[k], init_arrays[k])
    assert moved > len(a) // 2
    with open(os.path.join(pdir, "last", "meta.json")) as f:
        assert json.load(f)["step"] == 3


def test_resume_continues_bit_equal(root, tmp_path):
    """2 steps, then a resume to 4 from ``last`` (Adam, the port's own
    noise generator): the parameters equal 4 uninterrupted steps bit for
    bit."""
    full = _port_cfg(root, str(tmp_path), "full", "train.max_steps", "4")
    TL.fit(full, device="cpu")
    first = _port_cfg(root, str(tmp_path), "part", "train.max_steps", "2")
    part = TL.fit(first, device="cpu")
    again = _port_cfg(root, str(tmp_path), "part", "train.max_steps", "4",
                      "train.resume", "true", "train.ckpt_path",
                      os.path.join(part, "last"))
    TL.fit(again, device="cpu")
    a = _npz(os.path.join(tmp_path, "ck", "full", "last"))
    b = _npz(os.path.join(part, "last"))
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    with open(os.path.join(part, "last", "meta.json")) as f:
        assert json.load(f)["step"] == 4


def test_refine_freezes_the_field(root, tmp_path, capsys):
    """model_names_to_load ['anim_nerf'] without
    pretrained_model_requires_grad: the field is loaded and stays bit for
    bit; the body params move. A JAX checkpoint resumes with a fresh
    optimizer and says so."""
    init = str(tmp_path / "init")
    _jax_init_ckpt(_jax_cfg(root, str(tmp_path), "j"), init)
    cfg = _port_cfg(root, str(tmp_path), "r", "train.ckpt_path", init,
                    "train.model_names_to_load", "['anim_nerf']",
                    "train.max_steps", "2")
    out = TL.fit(cfg, device="cpu")
    with np.load(os.path.join(init, "anim_nerf.npz")) as a, \
            np.load(os.path.join(out, "last", "anim_nerf.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    from animnerf_tpu_torch.models.body_params import (
        load_body_params_from_dataset,
    )

    start = load_body_params_from_dataset(cfg.frame_IDs, root)
    with np.load(os.path.join(out, "last", "body_params.npz")) as b:
        assert any(not np.array_equal(b[k], start[k].numpy()) for k in b)

    resume = _port_cfg(root, str(tmp_path), "r2", "train.ckpt_path", init,
                       "train.resume", "true", "train.max_steps", "1")
    TL.fit(resume, device="cpu")
    assert "fresh optimizer" in capsys.readouterr().out


def test_checkpoints_cross_load_and_evaluate(root, tmp_path):
    """The train CLI on the CPU from a YAML file writes ``last`` in the
    JAX layout: JAX ``load_params`` reads it, the port reads a JAX
    checkpoint, and ``evaluate`` (and the test CLI) give JAX
    ``evaluate``'s PSNR and SSIM on the same checkpoint within 1e-4."""
    import yaml

    from animnerf_tpu.models.body_params import load_body_params_from_dataset
    from animnerf_tpu.training.checkpoints import load_params as jax_load
    from animnerf_tpu.training.loop import build_system as jax_build
    from animnerf_tpu.training.loop import evaluate as jax_evaluate
    from animnerf_tpu_torch.cli import test as test_cli
    from animnerf_tpu_torch.training.checkpoints import (
        load_params,
        system_params,
    )

    opts = _opts(root, str(tmp_path), "cli", "train.max_steps", "2")
    tree: dict = {}
    for k, v in zip(opts[::2], opts[1::2]):
        node = tree
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = yaml.safe_load(v.replace("(", "[").replace(")", "]"))
    cfg_file = str(tmp_path / "tiny.yaml")
    with open(cfg_file, "w") as f:
        yaml.safe_dump(tree, f)
    import subprocess

    r = subprocess.run(
        [sys.executable, "-m", "animnerf_tpu_torch.cli.train", "--device",
         "cpu", "--cfg_file", cfg_file], capture_output=True, text=True,
        timeout=300, cwd=os.path.dirname(os.path.dirname(__file__)),
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "mean psnr" in r.stdout
    last = os.path.join(tmp_path, "ck", "cli", "last")
    port_arrays = _npz(last)

    # the JAX package reads the port's checkpoint
    jcfg = _jax_cfg(root, str(tmp_path), "cli")
    jsys = jax_build(jcfg)
    params = jsys.init_params(jax.random.PRNGKey(1),
                              load_body_params_from_dataset(
                                  jcfg.frame_IDs, root))
    params = jax.tree.map(np.asarray, jax_load(last, params))
    for k, v in port_arrays.items():
        group, key = k.split(":")
        node = params[group]
        for p in key.split("/"):
            node = node[p]
        np.testing.assert_array_equal(np.asarray(node), v, err_msg=k)

    # the port reads a JAX checkpoint
    jck = str(tmp_path / "jck")
    _jax_init_ckpt(jcfg, jck)
    psys = TL.build_system(_port_cfg(root, str(tmp_path), "cli"), "cpu")
    from animnerf_tpu_torch.models.body_params import (
        load_body_params_from_dataset as port_body,
    )

    psys.set_body_params(port_body(jcfg.frame_IDs, root))
    load_params(jck, psys)
    got = system_params(psys)
    for k, v in _npz(jck).items():
        group, key = k.split(":")
        np.testing.assert_array_equal(got[group][key], v, err_msg=k)

    want = jax_evaluate(jcfg, last)
    jax.clear_caches()
    mine = TL.evaluate(_port_cfg(root, str(tmp_path), "cli"), last,
                       device="cpu")
    assert sorted(mine) == ["psnr", "ssim"] == sorted(want)
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], atol=1e-4, err_msg=k)
    means = test_cli.main(["--ckpt_path", last, "--device", "cpu"])
    for k in want:
        np.testing.assert_allclose(means[k], want[k], atol=1e-4, err_msg=k)


def test_tb_events_parse_with_the_jax_reader(tmp_path):
    from animnerf_tpu.utils.tb_events import read_events
    from animnerf_tpu_torch.utils.tb_events import EventWriter

    w = EventWriter(str(tmp_path))
    w.add_scalars({"train/loss": 0.5, "train/psnr": 21.0}, 3)
    img = np.random.default_rng(0).integers(0, 256, (6, 9, 3), np.uint8)
    w.add_image("val/gt_pred_depth", img, 4)
    w.close()
    ev = read_events(w.path)
    assert ev[0]["file_version"] == "brain.Event:2"
    assert ev[1]["step"] == 3 and ev[1]["scalars"] == {
        "train/loss": 0.5, "train/psnr": 21.0}
    png = ev[2]["images"]["val/gt_pred_depth"]
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(png)
    import cv2

    np.testing.assert_array_equal(
        cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1], img)


def test_entry_points_need_cuda_unless_cpu_is_asked(root, tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port_cfg(root, str(tmp_path), "x")
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.fit(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.evaluate(cfg, str(tmp_path))


def test_fit_ignores_mesh_shape(root, tmp_path):
    """``mesh_shape`` (4,) in one process trains bit for bit as (-1,):
    the JAX package's fit reads no mesh_shape either, and the mesh is the
    ranks of the process group that divide the batch (here one)."""
    outs = {}
    for shape in ("(-1,)", "(4,)"):
        out = str(tmp_path / shape.strip("(),-"))
        cfg = _port_cfg(root, out, "m", "mesh_shape", shape)
        outs[shape] = _npz(os.path.join(TL.fit(cfg, device="cpu"), "last"))
    a, b = outs["(-1,)"], outs["(4,)"]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)


def test_fit_trains_at_k_neigh_17(root, tmp_path):
    """k_neigh 17, past the 16 the port once took: fit takes two steps on
    the CPU (the plain versions of the kNN, warp-blend and scatter at 17
    neighbours), its losses finite, and writes ``last``."""
    cfg = _port_cfg(root, str(tmp_path), "k17", "k_neigh", "17",
                    "train.max_steps", "2")
    stats: dict = {}
    out = TL.fit(cfg, device="cpu", stats=stats)
    assert stats["system"].scene_cfg.k_neigh == 17
    assert len(stats["step_s"]) == 2
    assert stats["losses"] and all(np.isfinite(l) for _, l in stats["losses"])
    assert os.path.isfile(os.path.join(out, "last", "anim_nerf.npz"))


def test_profile_traces_steps_2_to_4(root, tmp_path):
    """ANIMNERF_PROFILE's trace: a torch.profiler chrome trace of the
    steps after the first two, in the log directory."""
    cfg = _port_cfg(root, str(tmp_path), "prof", "train.max_steps", "5")
    TL.fit(cfg, profile=True, device="cpu")
    path = os.path.join(cfg.logs_dir, "prof", "profile", "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::mm")
               for e in events)
