"""The port's image operations (``animnerf_tpu_torch/utils/image.py``)
against OpenCV, bit for bit: PNG decode of OpenCV-written files (every
row filter), linear resize, undistort, erode / dilate with the even
64 x 64 kernel, the JET table and the splat disc."""

from __future__ import annotations

import cv2
import numpy as np
import pytest
import torch

from animnerf_tpu_torch.utils import image as I

torch.set_num_threads(1)


def _noise(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _gradient(h, w, cn):
    y, x = np.mgrid[0:h, 0:w]
    chans = [(x * 255) // max(w - 1, 1), (y * 255) // max(h - 1, 1),
             ((x + y) * 255) // max(h + w - 2, 1), (x * y) % 256]
    return np.stack(chans[:cn], -1).astype(np.uint8)


def _images():
    for cn in (1, 3, 4):
        for name, img in (("noise", _noise((37, 53, cn), cn)),
                          ("gradient", _gradient(64, 48, cn))):
            yield f"{name}-{cn}", img[..., 0] if cn == 1 else img


def _filter_kinds(path):
    """The row filter types of a PNG file."""
    import zlib

    data = open(path, "rb").read()
    pos, idat, width, cn, height = 8, b"", 0, 0, 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            width, height = (int.from_bytes(body[0:4], "big"),
                             int.from_bytes(body[4:8], "big"))
            cn = {0: 1, 2: 3, 6: 4}[body[9]]
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = zlib.decompress(idat)
    return {raw[y * (width * cn + 1)] for y in range(height)}


# OpenCV's filter flags: each of the five alone, then the adaptive choice
_FILTERS = {"none": 8, "sub": 16, "up": 32, "average": 64, "paeth": 128,
            "adaptive": 8 | 16 | 32 | 64 | 128}


@pytest.mark.parametrize("flt", list(_FILTERS))
@pytest.mark.parametrize("name, img", list(_images()),
                         ids=[n for n, _ in _images()])
def test_read_png_matches_cv2_imread(tmp_path, name, img, flt):
    """OpenCV-written gray, RGB and RGBA files of noise and of smooth
    gradients under each row filter and under the adaptive choice: the
    decode equals cv2.imread(IMREAD_UNCHANGED) (in RGB(A) order), and
    write_png round-trips through both readers."""
    path = str(tmp_path / f"{name}.png")
    on_disk = img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]
    assert cv2.imwrite(path, on_disk, [cv2.IMWRITE_PNG_FILTER, _FILTERS[flt]])
    if flt != "adaptive":
        # a filter flag fixes the type of every row but the first
        want_kind = list(_FILTERS).index(flt)
        assert _filter_kinds(path) <= {0, want_kind}
    got = I.read_png(path)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if want.ndim == 3:
        want = want[..., [2, 1, 0, 3][:want.shape[2]]]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)
    mine = str(tmp_path / f"{name}-port.png")
    I.write_png(mine, img)
    np.testing.assert_array_equal(I.read_png(mine), img)
    back = cv2.imread(mine, cv2.IMREAD_UNCHANGED)
    if back.ndim == 3:
        back = back[..., [2, 1, 0, 3][:back.shape[2]]]
    np.testing.assert_array_equal(back, img)


def test_adaptive_png_mixes_filters(tmp_path):
    """Under the adaptive choice a noisy image's rows take several filter
    types, so one file exercises the decoder's switching."""
    path = str(tmp_path / "n.png")
    img = _noise((64, 64, 4), 9)
    img[32:] = _gradient(32, 64, 4)
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, _FILTERS["adaptive"]])
    assert len(_filter_kinds(path)) >= 2
    np.testing.assert_array_equal(I.read_png(path), img[..., [2, 1, 0, 3]])


@pytest.mark.parametrize("src, dst", [
    ((1080, 1080), (512, 512)), ((48, 48), (24, 24)), ((24, 24), (48, 48)),
    ((37, 53), (20, 31)), ((100, 60), (33, 77)), ((1080, 1920), (512, 512)),
    ((5, 9), (3, 7)),
])
@pytest.mark.parametrize("cn", [1, 3])
def test_resize_linear_matches_cv2(src, dst, cn):
    """(H, W) -> (H', W'): bit-equal to cv2.resize(INTER_LINEAR) on noise
    and on a smooth gradient (the 2x downscale takes OpenCV's box
    average)."""
    for img in (_noise(src + (cn,), 3), _gradient(*src, cn)):
        img = img[..., 0] if cn == 1 else img
        want = cv2.resize(img, (dst[1], dst[0]))
        got = I.resize_linear_u8(img, (dst[1], dst[0]))
        np.testing.assert_array_equal(got, want)


def _mask(h, w, seed):
    rng = np.random.default_rng(seed)
    m = (rng.random((h, w)) < 0.3).astype(np.float32)
    m[:6] = 1.0          # touches the top border
    m[:, -4:] = 1.0      # and the right one
    m[20:40, 10:30] = 1.0
    m[rng.random((h, w)) < 0.05] = 0.5
    return m


@pytest.mark.parametrize("k", [3, 64])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_erode_dilate_match_cv2(k, dtype):
    """OpenCV's anchor (k // 2, which places the even 64 x 64 kernel off
    centre) and its border, which never erodes or dilates from outside."""
    for seed, (h, w) in enumerate([(96, 80), (70, 130)]):
        m = _mask(h, w, seed)
        m = m if dtype == np.float32 else (m * 255).astype(np.uint8)
        kern = np.ones((k, k), np.uint8)
        np.testing.assert_array_equal(I.erode(m, k), cv2.erode(m, kern))
        np.testing.assert_array_equal(I.dilate(m, k), cv2.dilate(m, kern))


def test_jet_table_matches_cv2():
    want = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                             cv2.COLORMAP_JET)[:, 0, ::-1]
    np.testing.assert_array_equal(I.colormap_jet(), want)
    x = _noise((9, 11), 4)
    np.testing.assert_array_equal(
        I.apply_jet(x),
        cv2.cvtColor(cv2.applyColorMap(x, cv2.COLORMAP_JET),
                     cv2.COLOR_BGR2RGB))


@pytest.mark.parametrize("u, v", [(5, 5), (0, 0), (10, 3), (-1, 4), (11, 7)])
def test_disc_matches_cv2_circle(u, v):
    want = np.zeros((8, 12, 4), np.uint8)
    cv2.circle(want, (u, v), 2, (10, 20, 30, 255), -1)
    got = np.zeros((8, 12, 4), np.uint8)
    I.rasterize_disc(got, u, v, (10, 20, 30, 255))
    np.testing.assert_array_equal(got, want)


def test_overlapping_discs_paint_in_order():
    """Centres given as arrays paint as cv2.circle calls in turn: where
    discs overlap the later one's colour stays."""
    rng = np.random.default_rng(8)
    u, v = rng.integers(-2, 20, 40), rng.integers(-2, 14, 40)
    cols = rng.integers(1, 256, (40, 4))
    want = np.zeros((12, 18, 4), np.uint8)
    for i in range(40):
        cv2.circle(want, (int(u[i]), int(v[i])), 2,
                   tuple(int(x) for x in cols[i]), -1)
    got = np.zeros((12, 18, 4), np.uint8)
    I.rasterize_disc(got, u, v, cols)
    np.testing.assert_array_equal(got, want)


# People-Snapshot-like intrinsics at 512^2 (a 1080^2 camera scaled down)
_S = 512 / 1080
_K = np.array([[1296 * _S, 0, 540 * _S], [0, 1296 * _S, 540 * _S], [0, 0, 1]])


@pytest.mark.parametrize("coeffs", [
    [-0.2, 0.1, 0.001, -0.001, 0.0],
    [-0.26, 0.21, -0.0005, 0.0003, -0.05],
    [0.05, -0.02, 0.0, 0.0, 0.0],
])
def test_undistort_matches_cv2(coeffs):
    """Bit-equal to cv2.undistort with radial and tangential coefficients,
    on a resized noise image (RGB) and a smooth gradient and the mask
    (one channel)."""
    D = np.asarray(coeffs).reshape(-1, 1)
    img = I.resize_linear_u8(_noise((1080, 1080, 3), 5), (512, 512))
    for x in (img, _gradient(512, 512, 3), img[..., 0].copy()):
        np.testing.assert_array_equal(I.undistort_u8(x, _K, D),
                                      cv2.undistort(x, _K, D))


@pytest.mark.parametrize("coeffs", [
    # rational (k4..k6)
    [-0.2, 0.1, 0.001, -0.001, 0.01, 0.05, -0.02, 0.01],
    # + thin prism (s1..s4)
    [-0.26, 0.21, -0.0005, 0.0003, -0.05, 0.02, 0.01, -0.03,
     0.002, -0.001, 0.0015, 0.0005],
    # + tilt (tau_x, tau_y)
    [-0.2, 0.1, 0.001, -0.001, 0.01, 0.05, -0.02, 0.01,
     0.001, -0.002, 0.003, 0.0005, 0.02, -0.015],
], ids=["8", "12", "14"])
def test_undistort_full_model_matches_cv2(coeffs):
    """OpenCV's 8-, 12- and 14-coefficient models (rational radial factor,
    thin prism, tilted sensor): bit-equal to cv2.undistort on the same
    three images as the 5-coefficient test."""
    D = np.asarray(coeffs).reshape(-1, 1)
    img = I.resize_linear_u8(_noise((1080, 1080, 3), 7), (512, 512))
    for x in (img, _gradient(512, 512, 3), img[..., 0].copy()):
        np.testing.assert_array_equal(I.undistort_u8(x, _K, D),
                                      cv2.undistort(x, _K, D))


def test_undistort_takes_at_most_14_coefficients():
    with pytest.raises(ValueError, match="14"):
        I.undistort_maps(_K, np.zeros(15), 8, 8)


def test_undistort_zero_coefficients_is_the_identity():
    img = _noise((64, 80, 3), 6)
    K = np.array([[96.0, 0, 40], [0, 96.0, 32], [0, 0, 1]])
    D = np.zeros((5, 1))
    np.testing.assert_array_equal(I.undistort_u8(img, K, D), img)
    np.testing.assert_array_equal(cv2.undistort(img, K, D), img)
    # the map itself rounds to the identity too
    u, v = I.undistort_maps(K, D, 64, 80)
    np.testing.assert_array_equal(I.remap_linear_u8(img, u, v), img)
