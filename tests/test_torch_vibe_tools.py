"""The port's subject-from-video tools against the JAX package's on the
CPU: ``tools/vibe_driver.py`` (tracking, crops, the camera conversion,
the driver's ``vibe_output.pkl``), ``tools/convert_vibe.py``,
``tools/rvm.py`` and ``tools/vibe.py``, on the inputs
tests/test_tools.py and tests/test_vibe_driver.py fabricate and on
random ones. OpenCV writes the frames and runs inside the JAX tools; the
port's tools use none of it.

Bounds: everything bit-equal — IoUs, tracklets, crops (the port's
``resize_linear_u8`` is OpenCV's uint8 INTER_LINEAR), cameras, every
array of ``vibe_output.pkl`` and of the converted pickles, and the RVM
PNGs after decoding (the JAX tool's BGRA through cv2.imwrite is RGBA on
disk, the port's RGBA through write_png).
"""

from __future__ import annotations

import os
import pickle
import shutil
import sys
from typing import Optional

import numpy as np
import pytest
import torch

from animnerf_tpu_torch.smpl.loader import load_pickle
from animnerf_tpu_torch.tools import convert_vibe as CV
from animnerf_tpu_torch.tools import rvm as RVM
from animnerf_tpu_torch.tools import vibe_driver as VD
from animnerf_tpu_torch.utils.image import read_png

sys.path.insert(0, os.path.dirname(__file__))

torch.set_num_threads(1)

cv2 = pytest.importorskip("cv2")


def _same(got, want, what=""):
    """Nested dicts / arrays / scalars equal, arrays with their dtype."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), what
        for k in want:
            _same(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), what
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert type(got) is type(want) and got == want, what


# ----------------------------------------------------------- vibe_driver

def _random_boxes(rng, n):
    xy = rng.uniform(0, 100, size=(n, 2))
    wh = rng.uniform(1, 40, size=(n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_box_iou_bit_equal():
    from animnerf_tpu.tools.vibe_driver import box_iou

    rng = np.random.default_rng(0)
    a = np.array([[0, 0, 10, 10]], np.float32)
    b = np.array([[0, 0, 10, 10], [5, 5, 15, 15], [20, 20, 30, 30],
                  [3, 3, 3, 3]], np.float32)
    for x, y in ((a, b), (_random_boxes(rng, 7), _random_boxes(rng, 9)),
                 (np.zeros((0, 4)), b)):
        got, want = VD.box_iou(x, y), box_iou(x, y)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _walkers(n_frames, rng):
    """Per-frame detections of three people who cross, vanish for a few
    frames and come back, with one false detection now and then."""
    dets = []
    for f in range(n_frames):
        frame = []
        if f != 15:
            frame.append([10 + f, 20, 40 + f, 70])
        if f < 10 or f > 13:
            frame.append([80 - f, 30, 100 - f, 60])
        if 5 <= f < 25:
            frame.append([50, 5 + f, 70, 35 + f])
        if f % 7 == 3:
            frame.append(list(_random_boxes(rng, 1)[0]))
        dets.append(np.asarray(frame, np.float32).reshape(-1, 4))
    return dets


def test_tracker_bit_equal():
    """test_vibe_driver's two walkers with a missed frame, and three
    crossing walkers with gaps and false detections, at two gap limits:
    the same tracklet ids, boxes and frames."""
    from animnerf_tpu.tools.vibe_driver import track_people
    from test_vibe_driver import N_FRAMES, _gt_box_a, _gt_box_b

    dets = []
    for f in range(N_FRAMES):
        frame = [_gt_box_a(f)] + ([_gt_box_b(f)] if f < 10 else [])
        dets.append(np.asarray([] if f == 15 else frame,
                               np.float32).reshape(-1, 4))
    cases = [(dets, 2), (_walkers(40, np.random.default_rng(1)), 2),
             (_walkers(40, np.random.default_rng(2)), 0)]
    for d, gap in cases:
        got = VD.track_people(d, max_gap=gap)
        want = track_people(d, max_gap=gap)
        assert list(got) == list(want)
        _same(got, want)
    assert len(VD.track_people(cases[1][0])) >= 3


CROPS = [
    # (cx, cy, w, h, scale, out)
    (5.0, 5.0, 40, 40, 1.0, 32),        # off the top-left corner
    (64.0, 48.0, 20, 20, 1.0, 32),      # inside, upscaled 20 -> 32
    (64.0, 48.0, 30, 50, 1.1, 224),     # VIBE's scale and size
    (120.0, 90.0, 60, 30, 1.1, 32),     # off the bottom-right corner
    (64.0, 48.0, 64, 64, 1.0, 32),      # exactly 2x: OpenCV's box average
    (64.0, 48.0, 32, 32, 1.0, 32),      # the same size: a copy
    (30.3, 60.7, 77, 91, 1.1, 24),      # a non-integer shrink
    (64.0, 48.0, 300, 10, 1.1, 224),    # wider than the image
]


@pytest.mark.parametrize("crop", CROPS, ids=lambda c: "_".join(map(str, c)))
def test_crop_square_bit_equal(crop):
    """The port's crop (resize_linear_u8) against the JAX tool's
    (cv2.resize INTER_LINEAR), on random and on flat images."""
    from animnerf_tpu.tools.vibe_driver import crop_square

    cx, cy, w, h, scale, out = crop
    rng = np.random.default_rng(int(cx * 10 + w))
    for img in (rng.integers(0, 256, (96, 128, 3), dtype=np.uint8),
                np.full((96, 128, 3), 255, np.uint8)):
        got = VD.crop_square(img, cx, cy, w, h, scale=scale, out=out)
        want = crop_square(img, cx, cy, w, h, scale=scale, out=out)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (out, out, 3)
        np.testing.assert_array_equal(got, want)


def test_convert_crop_cam_bit_equal():
    from animnerf_tpu.tools.vibe_driver import convert_crop_cam_to_orig_img

    rng = np.random.default_rng(3)
    cam = np.concatenate([rng.uniform(0.5, 1.5, (50, 1)),
                          rng.normal(size=(50, 2))], 1).astype(np.float32)
    bbox = np.concatenate([rng.uniform(0, 128, (50, 2)),
                           rng.uniform(5, 80, (50, 2))], 1).astype(np.float32)
    for W, H in ((128, 96), (1080, 1920)):
        got = VD.convert_crop_cam_to_orig_img(cam, bbox, W, H)
        want = convert_crop_cam_to_orig_img(cam, bbox, W, H)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _torch_model(crops):
    """test_vibe_driver's fake regressor as torch tensors (a regressor on
    the card returns tensors; the driver takes them to the host)."""
    from test_vibe_driver import _model

    return {k: torch.from_numpy(np.asarray(v)) for k, v in
            _model(crops).items()}


def test_driver_and_convert_vibe_bit_equal(tmp_path):
    """test_vibe_driver's 30 frames of two walkers (one too short) through
    both drivers (the port's regressor returning tensors), then both
    converters on copies of an iper-style subject: vibe_output.pkl's
    arrays, the camera and every SMPL pickle bit-equal."""
    from animnerf_tpu.tools.convert_vibe import convert as jconvert
    from animnerf_tpu.tools.vibe_driver import run_vibe_driver
    from test_vibe_driver import N_FRAMES, _detector, _make_frames, _model

    images = _make_frames(tmp_path)
    want = run_vibe_driver(images, str(tmp_path / "jax"), _detector, _model,
                           batch_size=8)
    got = VD.run_vibe_driver(images, str(tmp_path / "port"), _detector,
                             _torch_model, batch_size=8)
    assert len(got) == 1 and list(got) == list(want)
    _same(got, want)
    with open(tmp_path / "jax" / "vibe_output.pkl", "rb") as fj, \
            open(tmp_path / "port" / "vibe_output.pkl", "rb") as fp:
        _same(pickle.load(fp), pickle.load(fj))
    tid = next(iter(got))
    assert len(got[tid]["frame_ids"]) == N_FRAMES

    roots = {}
    for side in ("jax", "port"):
        root = tmp_path / f"data_{side}"
        cam_dir = root / "subj" / "cam000"
        cam_dir.mkdir(parents=True)
        shutil.copytree(images, cam_dir / "images")
        for f in sorted(os.listdir(cam_dir / "images"), reverse=True):
            idx = int(os.path.splitext(f)[0])
            os.rename(cam_dir / "images" / f,
                      cam_dir / "images" / f"{idx + 1:06d}.png")
        shutil.copy(tmp_path / side / "vibe_output.pkl",
                    root / "subj" / "vibe_output.pkl")
        roots[side] = root
    jconvert(str(roots["jax"]), "subj", track_id=tid)
    CV.convert(str(roots["port"]), "subj", track_id=tid)
    _same_converted(roots["port"] / "subj", roots["jax"] / "subj", N_FRAMES)


def _same_converted(port, jax_dir, n):
    _same(load_pickle(str(port / "cam000" / "camera.pkl")),
          load_pickle(str(jax_dir / "cam000" / "camera.pkl")), "camera")
    names = sorted(os.listdir(jax_dir / "smpls"))
    assert names == sorted(os.listdir(port / "smpls")) and len(names) == n
    for name in names:
        _same(load_pickle(str(port / "smpls" / name)),
              load_pickle(str(jax_dir / "smpls" / name)), name)


@pytest.mark.parametrize("hw", [(64, 48), (31, 80)])
def test_convert_vibe_bit_equal(tmp_path, hw):
    """tests/test_tools.py's input (a 64x48 frame, five random VIBE
    frames), and an odd height: the camera (camera_c = [H // 2, W // 2]
    as the reference writes it) and the pickles bit-equal, transl z =
    2 f / (cam_s H) in float32."""
    from animnerf_tpu.tools.convert_vibe import convert as jconvert

    H, W = hw
    F = 5
    rng = np.random.default_rng(0)
    vibe = {1: {
        "orig_cam": rng.uniform(0.5, 1.5, size=(F, 4)).astype(np.float32),
        "betas": rng.normal(size=(F, 10)).astype(np.float32),
        "pose": rng.normal(scale=0.2, size=(F, 72)).astype(np.float32),
        "frame_ids": np.arange(F),
    }}
    for side in ("jax", "port"):
        root = tmp_path / side / "subj"
        (root / "cam000" / "images").mkdir(parents=True)
        cv2.imwrite(str(root / "cam000" / "images" / "000001.png"),
                    np.zeros((H, W, 3), np.uint8))
        with open(root / "vibe_output.pkl", "wb") as f:
            pickle.dump(vibe, f)
    jconvert(str(tmp_path / "jax"), "subj", "neutral")
    CV.convert(str(tmp_path / "port"), "subj", "neutral")
    _same_converted(tmp_path / "port" / "subj", tmp_path / "jax" / "subj", F)
    cam = load_pickle(str(tmp_path / "port" / "subj" / "cam000" /
                          "camera.pkl"))
    assert list(cam["camera_c"]) == [H // 2, W // 2]
    p = load_pickle(str(tmp_path / "port" / "subj" / "smpls" / "000001.pkl"))
    assert p["transl"].dtype == np.float32
    assert p["transl"][2] == np.float32(
        2 * 2000.0 / (vibe[1]["orig_cam"][0, 0] * H))


def test_convert_vibe_reads_without_joblib(tmp_path, monkeypatch):
    """Without joblib the pickle loader of smpl/loader.py reads the file."""
    import builtins

    real = builtins.__import__

    def no_joblib(name, *a, **k):
        if name == "joblib":
            raise ImportError(name)
        return real(name, *a, **k)

    path = tmp_path / "vibe_output.pkl"
    data = {1: {"frame_ids": np.arange(3), "pose": np.ones((3, 72))}}
    with open(path, "wb") as f:
        pickle.dump(data, f)
    monkeypatch.setattr(builtins, "__import__", no_joblib)
    _same(CV.load_vibe_output(str(path)), data)


# ------------------------------------------------------------------ rvm

def _frames(d, vals, rng=None):
    """test_tools.py's frames (flat, a distinct B channel) through
    cv2.imwrite, or random ones."""
    d.mkdir()
    for i, v in enumerate(vals):
        if rng is None:
            img = np.full((8, 6, 3), v, np.uint8)
            img[..., 0] = v // 2
        else:
            img = rng.integers(0, 256, (8, 6, 3), dtype=np.uint8)
        cv2.imwrite(str(d / f"{i:06d}.png"), img)


def _fake_model(seen):
    """test_tools.py's recurrent fake, with a per-pixel matte so the
    truncation to uint8 is exercised across values."""

    def model(src, r1, r2, r3, r4, ratio):
        assert ratio == 0.25 and src.dtype == torch.float32
        c = (torch.zeros(()) if r1 is None else r1) + 1.0
        seen.append(float(src.mean()))
        pha = torch.clamp(src.mean(dim=1, keepdim=True) + 0.001 * c, 0, 1)
        return src, pha, c, r2, r3, r4

    return model


def _same_rgba(port_dir, jax_dir, names):
    for n in names:
        want = cv2.imread(str(jax_dir / n), cv2.IMREAD_UNCHANGED)
        got = read_png(str(port_dir / n))
        assert got.shape == want.shape and got.shape[2] == 4, n
        np.testing.assert_array_equal(got, want[..., [2, 1, 0, 3]],
                                      err_msg=n)


@pytest.mark.parametrize("case", ["flat", "random", "fewer_than_warmup"])
def test_rvm_bit_equal(tmp_path, case):
    """The JAX driver and the port's with the same recurrent fake: the
    same frames fed in the same order (the warm-up reversed first), the
    same count written, no warm-up frame written, the RGBA PNGs equal
    after decoding; with two frames and warmup 4 the skip clips to the
    prefix there is."""
    from animnerf_tpu.tools.rvm import run_rvm

    vals = [40, 200] if case == "fewer_than_warmup" else \
        [10, 60, 110, 160, 210, 250]
    _frames(tmp_path / "imgs", vals,
            np.random.default_rng(5) if case == "random" else None)
    seen_j, seen_p = [], []
    nj = run_rvm(str(tmp_path / "imgs"), str(tmp_path / "jax"),
                 model=_fake_model(seen_j), warmup=4)
    np_ = RVM.run_rvm(str(tmp_path / "imgs"), str(tmp_path / "port"),
                      model=_fake_model(seen_p), warmup=4, device="cpu")
    assert nj == np_ == len(vals)
    assert seen_p == seen_j and len(seen_p) == len(vals) + min(4, len(vals))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert names == [f"{i:06d}.png" for i in range(len(vals))]
    _same_rgba(tmp_path / "port", tmp_path / "jax", names)


class TinyRVM(torch.nn.Module):
    """A small recurrent matting model with RVM's signature, scriptable."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.head = torch.nn.Conv2d(8, 1, 1)

    def forward(self, src, r1: Optional[torch.Tensor] = None,
                r2: Optional[torch.Tensor] = None,
                r3: Optional[torch.Tensor] = None,
                r4: Optional[torch.Tensor] = None,
                downsample_ratio: float = 0.25):
        h = torch.tanh(self.conv(src))
        if r1 is None:
            r1 = torch.zeros_like(h)
        r1 = 0.5 * r1 + 0.5 * h
        pha = torch.sigmoid(self.head(torch.cat([h, r1], 1)))
        return src, pha, r1, r2, r3, r4


def test_rvm_torchscript_checkpoint_bit_equal(tmp_path):
    """A scripted recurrent model saved as .torchscript: the port loads it
    with torch.jit.load(map_location=device), the JAX tool with
    torch.jit.load; the PNGs equal after decoding. Without a model or a
    checkpoint the port raises, naming what it needs."""
    from animnerf_tpu.tools.rvm import run_rvm

    torch.manual_seed(0)
    path = str(tmp_path / "rvm.torchscript")
    torch.jit.script(TinyRVM()).save(path)
    _frames(tmp_path / "imgs", range(6), np.random.default_rng(6))
    assert run_rvm(str(tmp_path / "imgs"), str(tmp_path / "jax"),
                   checkpoint=path) == 6
    assert RVM.main(["--images_dir", str(tmp_path / "imgs"), "--out_dir",
                     str(tmp_path / "port"), "--checkpoint", path,
                     "--device", "cpu"]) is None
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 6
    _same_rgba(tmp_path / "port", tmp_path / "jax", names)
    with pytest.raises(ValueError, match="checkpoint"):
        RVM.run_rvm(str(tmp_path / "imgs"), str(tmp_path / "x"),
                    device="cpu")


def test_jpeg_frames_raise_unless_a_reader_decodes_them(tmp_path):
    """A .jpg frame: the driver and RVM raise ValueError naming the file
    and pointing to tools/video_to_images; an injected reader (here
    OpenCV's) takes it."""
    img = np.random.default_rng(7).integers(0, 256, (96, 128, 3),
                                            dtype=np.uint8)
    d = tmp_path / "imgs"
    d.mkdir()
    cv2.imwrite(str(d / "000000.jpg"), img)
    with pytest.raises(ValueError, match=r"000000\.jpg.*video_to_images"):
        VD.run_vibe_driver(str(d), str(tmp_path / "v"),
                           lambda im: np.zeros((0, 4), np.float32),
                           _torch_model)
    with pytest.raises(ValueError, match=r"000000\.jpg.*video_to_images"):
        RVM.run_rvm(str(d), str(tmp_path / "r"), model=_fake_model([]),
                    device="cpu")

    def cv2_rgb(path):
        return cv2.imread(path)[..., ::-1].copy()

    out = VD.run_vibe_driver(str(d), str(tmp_path / "v"),
                             lambda im: np.zeros((0, 4), np.float32),
                             _torch_model, read_image=cv2_rgb)
    assert out == {}
    assert RVM.run_rvm(str(d), str(tmp_path / "r"), model=_fake_model([]),
                       device="cpu", read_image=cv2_rgb) == 1
    got = read_png(str(tmp_path / "r" / "000000.png"))
    np.testing.assert_array_equal(got[..., :3], cv2_rgb(str(d / "000000.jpg")))


def test_vibe_wrapper_without_a_checkout(tmp_path):
    """tools/vibe.py: the JAX wrapper's FileNotFoundError, word for word."""
    from animnerf_tpu.tools.vibe import run_vibe as jrun
    from animnerf_tpu_torch.tools.vibe import main, run_vibe

    with pytest.raises(FileNotFoundError) as want:
        jrun(str(tmp_path / "VIBE"), "in.mp4", str(tmp_path / "out"))
    with pytest.raises(FileNotFoundError) as got:
        run_vibe(str(tmp_path / "VIBE"), "in.mp4", str(tmp_path / "out"))
    assert str(got.value) == str(want.value) and "demo.py" in str(got.value)
    with pytest.raises(FileNotFoundError):
        main(["--vibe_repo", str(tmp_path), "--video_path", "in.mp4",
              "--out_dir", str(tmp_path / "out")])


def test_vibe_wrapper_runs_the_checkout_demo(tmp_path):
    """With a demo.py in the checkout the wrapper runs it from there with
    the JAX wrapper's arguments and returns <out>/<video name>/
    vibe_output.pkl."""
    from animnerf_tpu_torch.tools.vibe import run_vibe

    repo = tmp_path / "VIBE"
    repo.mkdir()
    (repo / "demo.py").write_text(
        "import json, os, sys\n"
        "a = sys.argv[1:]\n"
        "out = os.path.join(a[a.index('--output_folder') + 1], 'clip')\n"
        "os.makedirs(out)\n"
        "json.dump([os.getcwd()] + a, open(os.path.join(out, "
        "'vibe_output.pkl'), 'w'))\n")
    path = run_vibe(str(repo), "clip.mp4", str(tmp_path / "out"))
    assert path == str(tmp_path / "out" / "clip" / "vibe_output.pkl")
    import json

    with open(path) as f:
        args = json.load(f)
    assert args == [str(repo), "--vid_file", "clip.mp4", "--output_folder",
                    str(tmp_path / "out"), "--tracker_batch_size", "12",
                    "--no_render"]
