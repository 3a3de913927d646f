"""The port's data-preparation tools against the JAX package's, on the
CPU: ``tools/prepare_template.py``, ``tools/people_snapshot.py`` (with
its Rodrigues and nearest resize in numpy) and ``tools/video_to_images.py``'s
crop. OpenCV and h5py fabricate the inputs and run the JAX tools; the
port's tools use neither (h5py only inside ``prepare``). Nothing here
runs ffmpeg: the port's People-Snapshot tool is fed the frames OpenCV
decoded from the same mp4 through its decoder argument.

Bounds: the Rodrigues matrix within 2 ulps of ``cv2.Rodrigues`` (it is
bit-equal on every vector tried); the nearest resize, every PNG after
decoding and every SMPL pickle bit-equal; the template's points
bit-equal and its distances within the mesh-distance bound (1e-12
relative in float64) on one mesh, the two tools' meshes within the body
models' 1e-5.
"""

from __future__ import annotations

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from animnerf_tpu_torch.smpl.loader import load_pickle
from animnerf_tpu_torch.tools import people_snapshot as PS
from animnerf_tpu_torch.utils.image import read_png, write_png

torch.set_num_threads(1)

cv2 = pytest.importorskip("cv2")


def test_rodrigues_matches_opencv():
    """2,000 rotation vectors from 1e-20 to 10 rad in norm (below
    DBL_EPSILON the identity): within 2 ulps of cv2.Rodrigues, and
    bit-equal."""
    rng = np.random.default_rng(0)
    worst, unequal = 0.0, 0
    for scale in (1e-20, 1e-12, 1e-6, 1e-2, 0.5, 1.0, 3.0, 10.0):
        for r in rng.normal(size=(250, 3)) * scale:
            want = cv2.Rodrigues(r)[0]
            got = PS.rodrigues(r)
            assert got.dtype == np.float64 and got.shape == (3, 3)
            ulps = np.abs(got - want) / np.spacing(
                np.maximum(np.abs(want), np.finfo(np.float64).tiny))
            worst = max(worst, float(ulps.max()))
            unequal += int(not np.array_equal(got, want))
    assert worst <= 2.0
    assert unequal == 0
    np.testing.assert_array_equal(PS.rodrigues(np.zeros(3)), np.eye(3))


@pytest.mark.parametrize("src,dst", [
    ((12, 10), (24, 20)),     # 2x
    ((24, 20), (12, 10)),     # 0.5x
    ((70, 30), (30, 13)),     # 3/7 in both axes
    ((30, 13), (70, 30)),     # 7/3
    ((1080, 1080), (1920, 1080)),
])
def test_resize_nearest_matches_opencv(src, dst):
    """The mask resize against cv2.resize(INTER_NEAREST), bit for bit, on
    a 2-D uint8 mask and a 3-channel image."""
    rng = np.random.default_rng(sum(src) + sum(dst))
    (w, h), (W, H) = src, dst
    for img in (rng.integers(0, 256, (h, w), dtype=np.uint8),
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8)):
        want = cv2.resize(img, (W, H), interpolation=cv2.INTER_NEAREST)
        got = PS.resize_nearest(img, (W, H))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _fabricate_release(raw, H, W, F, mask_hw, rng):
    """A raw People-Snapshot subject: mp4 (OpenCV's mp4v), masks.hdf5 at
    mask_hw, reconstructed_poses.hdf5 and camera.pkl with a non-zero
    rotation vector."""
    import h5py

    raw.mkdir(parents=True)
    vw = cv2.VideoWriter(str(raw / f"{raw.name}.mp4"),
                         cv2.VideoWriter_fourcc(*"mp4v"), 5, (W, H))
    for _ in range(F):
        vw.write(rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8))
    vw.release()
    mh, mw = mask_hw
    with h5py.File(raw / "masks.hdf5", "w") as f:
        m = np.zeros((F, mh, mw), np.uint8)
        m[:, mh // 4: 3 * mh // 4, mw // 5: 4 * mw // 5] = 1
        m[1, 0, 0] = 7
        f.create_dataset("masks", data=m)
    with h5py.File(raw / "reconstructed_poses.hdf5", "w") as f:
        f.create_dataset("pose", data=rng.normal(size=(F, 72)).astype(
            np.float32))
        f.create_dataset("trans", data=rng.normal(size=(F, 3)).astype(
            np.float32))
        f.create_dataset("betas", data=rng.normal(size=10).astype(
            np.float32))
    with open(raw / "camera.pkl", "wb") as f:
        pickle.dump({"camera_rt": rng.normal(scale=0.3, size=3),
                     "camera_t": rng.normal(size=3),
                     "camera_f": np.array([500.0, 510.0]),
                     "camera_c": np.array([W / 2, H / 2]),
                     "camera_k": rng.normal(scale=0.01, size=5)}, f)


def cv2_decoder(video_path):
    """What the JAX tool reads (cv2.VideoCapture), as the port's decoder
    contract: (width, height, count, RGB frames)."""
    cap = cv2.VideoCapture(video_path)
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))

    def frames():
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield frame[..., ::-1].copy()
        finally:
            cap.release()

    return width, height, count, frames()


def _same_tree(jax_dir, port_dir, F):
    cam_j = load_pickle(os.path.join(jax_dir, "cam000", "camera.pkl"))
    cam_t = load_pickle(os.path.join(port_dir, "cam000", "camera.pkl"))
    assert sorted(cam_j) == sorted(cam_t)
    for k, v in cam_j.items():
        if k == "R":
            ulps = np.abs(cam_t[k] - v) / np.spacing(np.abs(v))
            assert cam_t[k].dtype == v.dtype and float(ulps.max()) <= 2.0
        else:
            assert type(cam_t[k]) is type(v), k
            np.testing.assert_array_equal(cam_t[k], v, err_msg=k)
    names = sorted(os.listdir(os.path.join(jax_dir, "cam000", "images")))
    assert names == sorted(os.listdir(os.path.join(port_dir, "cam000",
                                                   "images")))
    assert len(names) == F
    for n in names:
        a = cv2.imread(os.path.join(jax_dir, "cam000", "images", n),
                       cv2.IMREAD_UNCHANGED)
        b = read_png(os.path.join(port_dir, "cam000", "images", n))
        np.testing.assert_array_equal(b, a[..., [2, 1, 0, 3]], err_msg=n)
    for n in sorted(os.listdir(os.path.join(jax_dir, "smpls"))):
        pj = load_pickle(os.path.join(jax_dir, "smpls", n))
        pt = load_pickle(os.path.join(port_dir, "smpls", n))
        assert sorted(pj) == sorted(pt)
        for k in pj:
            assert pt[k].dtype == pj[k].dtype and pt[k].shape == pj[k].shape
            np.testing.assert_array_equal(pt[k], pj[k], err_msg=f"{n}:{k}")


@pytest.mark.parametrize("mask_hw", [(32, 24), (14, 10)])
def test_people_snapshot_matches_jax(tmp_path, mask_hw):
    """A fabricated release (masks at the frame size, and at 14x10, which
    takes the nearest resize at non-integer ratios): the JAX tool reads the
    mp4 with OpenCV, the port's is fed the same decoded frames; every PNG,
    SMPL pickle and camera entry equal (R within 2 ulps). Then the port's
    route from a directory of extracted frames gives the same tree, also
    from its command line."""
    from animnerf_tpu.tools.people_snapshot import prepare as jax_prepare

    H, W, F = 32, 24, 3
    raw = tmp_path / "male-9-test"
    _fabricate_release(raw, H, W, F, mask_hw, np.random.default_rng(0))
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_prepare(str(raw), jax_out)
    assert PS.prepare(str(raw), port_out, decoder=cv2_decoder) == F
    _same_tree(jax_out, port_out, F)

    frames = tmp_path / "frames"
    frames.mkdir()
    _, _, _, decoded = cv2_decoder(str(raw / f"{raw.name}.mp4"))
    for i, fr in enumerate(decoded):
        write_png(str(frames / f"{i + 1:06d}.png"), fr)
    dir_out = str(tmp_path / "port_dir")
    assert PS.prepare(str(raw), dir_out, frames_dir=str(frames)) == F
    _same_tree(jax_out, dir_out, F)
    cli_out = str(tmp_path / "port_cli")
    PS.main(["--people_dir", str(raw), "--out_dir", cli_out,
             "--frames_dir", str(frames)])
    _same_tree(jax_out, cli_out, F)


def test_center_crop_matches_jax(tmp_path):
    """video_to_images' crop through the port's PNG codec against JAX's
    center_crop on RGB and RGBA frames, with offsets (one past the edge)."""
    from animnerf_tpu.utils.video import center_crop as jax_crop
    from animnerf_tpu_torch.tools.video_to_images import crop_images

    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, (30, 40, c), dtype=np.uint8)
            for c in (3, 4, 3)]
    for crop, offset in (((16, 12), (0, 0)), ((20, 10), (3, -2)),
                         ((40, 30), (5, 5))):
        d = tmp_path / f"{crop[0]}_{offset[0]}"
        d.mkdir()
        for i, img in enumerate(imgs):
            write_png(str(d / f"{i + 1:06d}.png"), img)
        (d / "notes.txt").write_text("not a frame")
        assert crop_images(str(d), crop, offset) == len(imgs)
        for i, img in enumerate(imgs):
            got = read_png(str(d / f"{i + 1:06d}.png"))
            np.testing.assert_array_equal(got, jax_crop(img, crop, offset))


@pytest.fixture(scope="module")
def templates(tmp_path_factory):
    """One synthetic dataset and X-pose asset; JAX's prepare_template and
    the port's (on the CPU) each on its own copy."""
    from animnerf_tpu.tools.prepare_template import prepare_template as jpt
    from animnerf_tpu_torch.data.synthetic import write_synthetic_dataset
    from animnerf_tpu_torch.tools.prepare_template import prepare_template
    from animnerf_tpu_torch.utils.io import write_pickle_file

    tmp = tmp_path_factory.mktemp("tmpl")
    root = tmp / "jax" / "subj"
    write_synthetic_dataset(str(root), num_frames=3, img_wh=(16, 16),
                            num_verts=200, num_joints=10, seed=3)
    os.remove(root / "smpl_template.pkl")
    shutil.copytree(tmp / "jax", tmp / "port")
    xp = str(tmp / "X_pose.pkl")
    rng = np.random.default_rng(4)
    write_pickle_file(xp, {
        "betas": np.zeros((1, 10), np.float32),
        "global_orient": rng.normal(scale=0.1, size=3).astype(np.float32),
        "body_pose": rng.normal(scale=0.3, size=27).astype(np.float32),
        "transl": rng.normal(scale=0.1, size=3).astype(np.float32)})
    kw = dict(gender="neutral", template_path=xp, num_points=1500)
    pj = jpt(str(tmp / "jax"), "subj", model_path=str(root / "models"),
             chunk=256, **kw)
    pt = prepare_template(str(tmp / "port"), "subj", device="cpu",
                          model_path=str(tmp / "port" / "subj" / "models"),
                          **kw)
    assert os.path.basename(pj) == os.path.basename(pt)
    # the command line writes the same file
    from animnerf_tpu_torch.tools.prepare_template import main

    first = load_pickle(pt)
    main(["--data_root", str(tmp / "port"), "--people_ID", "subj",
          "--gender", "neutral", "--model_path",
          str(tmp / "port" / "subj" / "models"), "--template_path", xp,
          "--num_points", "1500", "--chunk", "100", "--device", "cpu"])
    again = load_pickle(pt)
    assert sorted(again) == sorted(first) and all(
        np.array_equal(np.asarray(again[k]), np.asarray(first[k]))
        for k in first)
    return load_pickle(pj), again


def test_prepare_template_matches_jax(templates):
    """Every key, dtype and shape; the shape and pose entries and the faces
    bit-equal; the posed mesh within the body models' bound (1e-5, as
    tests/test_torch_smpl.py), and so the box, the points and the unsigned
    distances within it. The signs agree on all but a few points: the
    synthetic rig's faces are an open, self-overlapping strip (i, i+1,
    i+2), so where a point's closest feature is a vertex the faces sharing
    it tie, and which wins (and whose normal signs the point) moves with
    the 1e-7 differences of the two body models' meshes. On one mesh the
    signs are equal (the next test)."""
    j, t = templates
    assert sorted(j) == sorted(t)
    for k in j:
        if isinstance(j[k], str):
            assert t[k] == j[k], k
            continue
        a, b = np.asarray(j[k]), np.asarray(t[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k in ("betas", "body_pose", "global_orient", "transl", "faces"):
            np.testing.assert_array_equal(b, a, err_msg=k)
        elif k == "distances":
            np.testing.assert_allclose(np.abs(b), np.abs(a), atol=1e-5,
                                       rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=0, err_msg=k)
    assert (np.sign(t["distances"]) == np.sign(j["distances"])).mean() > 0.98
    assert (t["distances"] < -0.02).sum() > 5 and (t["distances"] > 0.1).any()


def test_template_points_and_distances_on_the_same_mesh(templates):
    """Fed the JAX tool's mesh, the port's box and points are bit-equal to
    the JAX tool's (the same default_rng draws), and its signed distances
    round to the JAX tool's float32 distances within the mesh-distance
    bound."""
    from animnerf_tpu.ops.mesh_distance import signed_distance as jax_sd
    from animnerf_tpu_torch.ops.mesh_distance import signed_distance
    from animnerf_tpu_torch.tools.prepare_template import template_points

    j, _ = templates
    center, bbox, pts = template_points(j["verts"], len(j["points"]), seed=0)
    np.testing.assert_array_equal(center, j["center"])
    np.testing.assert_array_equal(bbox, j["bbox"])
    np.testing.assert_array_equal(pts.astype(np.float32), j["points"])
    got = signed_distance(pts, j["verts"], j["faces"]).numpy()
    want = jax_sd(pts, j["verts"], j["faces"], chunk=256)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    np.testing.assert_array_equal(got.astype(np.float32), j["distances"])
