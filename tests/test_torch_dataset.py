"""The port's data pipeline against the JAX package's, on a synthetic
dataset on disk: ``AnimNeRFDataset`` / ``Loader`` batches bit for bit
(training with ``foreground_pixel`` and ``pixel`` sampling, the frame
cache on and off, resized and undistorted frames, and the val mode), the
port's dataset writer, the body params of a dataset, ``create`` from a
model file and the config merges."""

from __future__ import annotations

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from animnerf_tpu.config import get_default_config as jax_default_config
from animnerf_tpu.data import dataset as JD
from animnerf_tpu.data.synthetic import (
    write_synthetic_dataset as jax_write_dataset,
)
from animnerf_tpu_torch.config import get_default_config
from animnerf_tpu_torch.data import dataset as TD
from animnerf_tpu_torch.data.synthetic import write_synthetic_dataset

torch.set_num_threads(1)

NJ = 8        # joints of the tiny rig: body_pose is 3 * 7 wide
SIZE = 32     # frames on disk are SIZE x SIZE


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jds"))
    jax_write_dataset(root, num_frames=4, img_wh=(SIZE, SIZE),
                      num_verts=128, num_joints=NJ, seed=7)
    return root


@pytest.fixture(scope="module")
def distorted_root(jax_root, tmp_path_factory):
    """The same frames behind a camera with People-Snapshot-like radial
    and tangential distortion."""
    root = str(tmp_path_factory.mktemp("dds"))
    shutil.copytree(jax_root, root, dirs_exist_ok=True)
    path = os.path.join(root, "cam000", "camera.pkl")
    with open(path, "rb") as f:
        cam = pickle.load(f)
    cam["camera_k"] = np.array([-0.2, 0.1, 0.001, -0.001, 0.0])
    with open(path, "wb") as f:
        pickle.dump(cam, f)
    return root


@pytest.fixture(scope="module")
def rational_root(jax_root, tmp_path_factory):
    """The same frames behind a camera with OpenCV's 8-coefficient
    (rational) distortion model."""
    root = str(tmp_path_factory.mktemp("rds"))
    shutil.copytree(jax_root, root, dirs_exist_ok=True)
    path = os.path.join(root, "cam000", "camera.pkl")
    with open(path, "rb") as f:
        cam = pickle.load(f)
    cam["camera_k"] = np.array([-0.2, 0.1, 0.001, -0.001, 0.01, 0.05,
                                -0.02, 0.01])
    with open(path, "wb") as f:
        pickle.dump(cam, f)
    return root


def _kwargs(mode, subsampletype="foreground_pixel", img_wh=(SIZE, SIZE)):
    return dict(mode=mode, img_wh=img_wh, frame_start_ID=1,
                frame_end_ID=4 if mode == "train" else 2, frame_skip=1,
                subsampletype=subsampletype, subsamplesize=8,
                frame_ids_index={1: 0, 2: 1, 3: 2}, seed=5)


def _assert_batches_equal(a_loader, b_loader, epochs=2):
    n = 0
    for epoch in range(epochs):
        for a, b in zip(a_loader.epoch(epoch), b_loader.epoch(epoch),
                        strict=True):
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            n += 1
    assert n > 0


@pytest.mark.parametrize("camera", ["plain", "distorted"])
@pytest.mark.parametrize("img_wh", [(SIZE, SIZE), (24, 20)],
                         ids=["native", "resized"])
@pytest.mark.parametrize("subsampletype, cache", [
    ("foreground_pixel", True), ("foreground_pixel", False),
    ("pixel", True)])
def test_train_batches_bit_equal(jax_root, distorted_root, monkeypatch,
                                 camera, img_wh, subsampletype, cache):
    """Two epochs of training batches: the same pixels, rays, colours,
    masks, fg/bg points and body params, bit for bit (the frame cache
    off takes the dense per-draw path)."""
    monkeypatch.setenv("ANIMNERF_FRAME_CACHE_MB", "2048" if cache else "0")
    root = jax_root if camera == "plain" else distorted_root
    kw = _kwargs("train", subsampletype, img_wh)
    a = JD.Loader(JD.AnimNeRFDataset(root, **kw), 3, shuffle=True, seed=11)
    b = TD.Loader(TD.AnimNeRFDataset(root, **kw), 3, shuffle=True, seed=11)
    assert len(a) == len(b)
    _assert_batches_equal(a, b)


@pytest.mark.parametrize("camera", ["plain", "distorted"])
def test_val_frames_bit_equal(jax_root, distorted_root, camera):
    root = jax_root if camera == "plain" else distorted_root
    kw = _kwargs("val", img_wh=(24, 20))
    a = JD.Loader(JD.AnimNeRFDataset(root, **kw), 1, shuffle=False)
    b = TD.Loader(TD.AnimNeRFDataset(root, **kw), 1, shuffle=False)
    _assert_batches_equal(a, b, epochs=1)
    # a distorted camera really moves the pixels
    if camera == "distorted":
        c = TD.AnimNeRFDataset(jax_root, **kw)[0]["rgbs"]
        d = TD.AnimNeRFDataset(root, **kw)[0]["rgbs"]
        assert not np.array_equal(c, d)


def test_port_writer_reads_the_same_through_both_readers(tmp_path):
    """A dataset that the port writes: both packages read the same
    batches, and its frames hold splats."""
    root = str(tmp_path / "tds")
    path = write_synthetic_dataset(root, num_frames=3, img_wh=(SIZE, SIZE),
                                   num_verts=128, num_joints=NJ, seed=3)
    assert os.path.isfile(path)
    kw = dict(_kwargs("train"), frame_end_ID=3)
    a = JD.Loader(JD.AnimNeRFDataset(root, **kw), 2, seed=1)
    b = TD.Loader(TD.AnimNeRFDataset(root, **kw), 2, seed=1)
    _assert_batches_equal(a, b)
    import cv2

    img = cv2.imread(os.path.join(root, "cam000", "images", "000001.png"),
                     cv2.IMREAD_UNCHANGED)
    assert img.shape == (SIZE, SIZE, 4) and (img[..., 3] == 255).sum() > 20


def test_port_writer_matches_the_jax_writer_files(jax_root, tmp_path):
    """Same seed and sizes: the same body model, camera, parameter files
    and template, and frames that differ at most where a vertex's
    projection rounds to another pixel (the body model's float32 sums
    differ by ulps between the packages)."""
    from animnerf_tpu.smpl.loader import load_pickle

    root = str(tmp_path / "tds")
    write_synthetic_dataset(root, num_frames=4, img_wh=(SIZE, SIZE),
                            num_verts=128, num_joints=NJ, seed=7)
    for rel in ("models/SMPL_NEUTRAL.pkl", "cam000/camera.pkl",
                "smpls/000002.pkl"):
        a, b = (load_pickle(os.path.join(r, rel)) for r in (jax_root, root))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)
    a, b = (load_pickle(os.path.join(r, "smpl_template.pkl"))
            for r in (jax_root, root))
    np.testing.assert_allclose(a["distances"], b["distances"], atol=1e-5)
    from animnerf_tpu_torch.utils.image import read_png

    for fid in range(1, 5):
        name = os.path.join("cam000", "images", f"{fid:06d}.png")
        x = read_png(os.path.join(jax_root, name)).astype(int)
        y = read_png(os.path.join(root, name)).astype(int)
        assert (x != y).any(-1).mean() < 0.02


def test_body_params_from_dataset_equal(jax_root):
    from animnerf_tpu.models.body_params import (
        load_body_params_from_dataset as jax_load,
    )
    from animnerf_tpu_torch.models.body_params import (
        load_body_params_from_dataset,
    )

    a = jax_load([1, 2, 4], jax_root)
    b = load_body_params_from_dataset([1, 2, 4], jax_root)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())
    assert b["body_pose"].shape == (3, 3 * (NJ - 1))


@pytest.mark.parametrize("sparse", [False, True])
def test_create_poses_like_jax(tmp_path, sparse):
    """A model file that the port's ``save_model_data`` writes (its
    J_regressor as a scipy sparse matrix too): ``create`` + ``forward``
    in both packages give the same vertices, joints (the keypoint ids
    clamped to the small mesh) and transforms."""
    import jax.numpy as jnp
    import scipy.sparse

    from animnerf_tpu.smpl import body_model as JB
    from animnerf_tpu_torch.data.synthetic import make_rig
    from animnerf_tpu_torch.smpl import body_model as TB
    from animnerf_tpu_torch.smpl.loader import (
        load_model_data,
        save_model_data,
    )

    rig = make_rig(300, 24, seed=4)
    if sparse:
        rig["J_regressor"] = scipy.sparse.csc_matrix(rig["J_regressor"])
    path = str(tmp_path / "SMPL_NEUTRAL.pkl")
    save_model_data(path, rig)
    data = load_model_data(str(tmp_path), "smpl", "neutral")
    assert isinstance(data["J_regressor"], np.ndarray)
    jm = JB.create(str(tmp_path), "smpl", "neutral")
    tm = TB.create(str(tmp_path), "smpl", "neutral")
    rng = np.random.default_rng(0)
    p = {"betas": rng.normal(scale=0.5, size=(2, 10)),
         "global_orient": rng.normal(scale=0.3, size=(2, 3)),
         "body_pose": rng.normal(scale=0.3, size=(2, 69)),
         "transl": rng.normal(scale=0.2, size=(2, 3))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    a = JB.forward(jm, **{k: jnp.asarray(v) for k, v in p.items()})
    b = TB.forward(tm, **{k: torch.from_numpy(v) for k, v in p.items()})
    assert b.joints.shape == a.joints.shape == (2, 24 + 21, 3)
    for name in ("vertices", "joints", "joints_transform",
                 "vertices_transform"):
        np.testing.assert_allclose(getattr(b, name).numpy(),
                                   np.asarray(getattr(a, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_cfg_merges_equal(tmp_path):
    """The same YAML and options through both packages' CfgNode give the
    same config, coerced values and derived fields included."""
    from animnerf_tpu.config import finalize as jax_finalize
    from animnerf_tpu_torch.config import finalize

    yaml_text = ("exp_name: x\nimg_wh: [48, 32]\nn_samples: 16\n"
                 "train:\n  frame_end_ID: 40\n  lr: 1\n"
                 "  optimizer: {type: sgd}\n  cam_IDs: [0, 2]\n"
                 "val:\n  vis_freq: 3\n")
    path = str(tmp_path / "c.yaml")
    with open(path, "w") as f:
        f.write(yaml_text)
    opts = ["train.max_steps", "7", "white_bkgd", "false", "seed", "3",
            "mesh_shape", "(1,)", "train.scheduler.poly_exp", "2"]
    a, b = jax_default_config(), get_default_config()
    for c in (a, b):
        c.merge_from_file(path)
        c.merge_from_list(opts)
    a, b = jax_finalize(a), finalize(b)
    assert a == b
    assert b.img_wh == (48, 32) and isinstance(b.train.lr, float)
    assert b.white_bkgd is False and b.num_frames == 10
    with pytest.raises(KeyError):
        b.merge_from_list(["no_such_key", "1"])


def test_rational_camera_batches_bit_equal(jax_root, rational_root):
    """An 8-coefficient camera (k4..k6 of OpenCV's rational model, which
    the JAX loader hands to cv2.undistort): training batches and a
    validation frame bit-equal to the JAX loader's, and the pixels moved
    against the undistorted camera."""
    kw = _kwargs("train", img_wh=(24, 20))
    a = JD.Loader(JD.AnimNeRFDataset(rational_root, **kw), 3, shuffle=True,
                  seed=11)
    b = TD.Loader(TD.AnimNeRFDataset(rational_root, **kw), 3, shuffle=True,
                  seed=11)
    _assert_batches_equal(a, b, epochs=1)
    kv = _kwargs("val", img_wh=(24, 20))
    _assert_batches_equal(
        JD.Loader(JD.AnimNeRFDataset(rational_root, **kv), 1, shuffle=False),
        TD.Loader(TD.AnimNeRFDataset(rational_root, **kv), 1, shuffle=False),
        epochs=1)
    c = TD.AnimNeRFDataset(jax_root, **kv)[0]["rgbs"]
    d = TD.AnimNeRFDataset(rational_root, **kv)[0]["rgbs"]
    assert not np.array_equal(c, d)
