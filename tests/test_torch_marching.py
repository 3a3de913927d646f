"""The port's host-side mesh and image tools against the JAX package's, on
the CPU: marching tetrahedra (native and numpy), ``smooth``, the mesh
CLI's grid helpers, the software rasterizer and the GIF writer; and no
hidden fallback when the host library cannot be built."""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from animnerf_tpu.cli import extract_mesh as jax_em
from animnerf_tpu.ops import marching as jax_mc
from animnerf_tpu_torch.cli import extract_mesh as em
from animnerf_tpu_torch.ops import marching as mc
from animnerf_tpu_torch.utils import host_lib

torch.set_num_threads(1)


def sphere_field(n: int, r: float) -> np.ndarray:
    x = np.linspace(-0.5, 0.5, n)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    return (np.sqrt(X**2 + Y**2 + Z**2) - r).astype(np.float32)


def noisy_field(n: int) -> np.ndarray:
    """A smoothed random field: many small surfaces, every tetrahedron
    case, some corners exactly at the iso value."""
    rng = np.random.default_rng(3)
    f = mc.smooth(rng.normal(size=(n, n, n)).astype(np.float32))
    f[rng.random(f.shape) < 0.01] = 0.0
    return f


FIELDS = {"sphere": lambda: sphere_field(24, 0.3),
          "noisy": lambda: noisy_field(20)}


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("which", ["native", "numpy"])
def test_marching_tets_bit_equal_to_jax(name, which):
    """Vertices and triangles, bit for bit, of the same function in both
    packages (the native ones from the port's and the JAX package's own
    builds of the same source)."""
    field = FIELDS[name]()
    fn = f"marching_tets_{which}"
    v, t = getattr(mc, fn)(field, 0.0)
    jv, jt = getattr(jax_mc, fn)(field, 0.0)
    assert len(t) > 100
    assert v.dtype == jv.dtype == np.float32 and t.dtype == jt.dtype
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t, jt)


def test_marching_cubes_is_the_native_version():
    field = sphere_field(24, 0.3)
    for a, b in zip(mc.marching_cubes(field, 0.0),
                    mc.marching_tets_native(field, 0.0)):
        np.testing.assert_array_equal(a, b)


def test_smooth_bit_equal_to_jax():
    field = noisy_field(20)
    np.testing.assert_array_equal(mc.smooth(field), jax_mc.smooth(field))
    np.testing.assert_array_equal(mc.smooth(field, 2.0),
                                  jax_mc.smooth(field, 2.0))


@pytest.mark.parametrize("N", [24, 256])
def test_grid_helpers_bit_equal_to_jax(N):
    ranges = ([-1.2, 1.2], [-1.0, 1.3], [-0.7, 0.9])
    np.testing.assert_array_equal(em.create_grid(N, *ranges),
                                  jax_em.create_grid(N, *ranges))
    rng = np.random.default_rng(N)
    verts = (rng.random((500, 3)) * (N - 1)).astype(np.float32)
    np.testing.assert_array_equal(em.grid_to_world(verts, N, *ranges),
                                  jax_em.grid_to_world(verts, N, *ranges))


def test_marching_raises_when_the_build_fails(monkeypatch, tmp_path):
    """No numpy fallback: a missing source (or a failed g++) raises."""
    monkeypatch.setattr(host_lib, "SRC_DIR", tmp_path / "no_such_dir")
    monkeypatch.setattr(host_lib, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(host_lib, "_LIB", None)
    with pytest.raises(FileNotFoundError):
        mc.marching_cubes(sphere_field(8, 0.3), 0.0)
    from animnerf_tpu_torch.utils.renderer import SoftwareRenderer

    verts, faces = _triangle()
    with pytest.raises(FileNotFoundError):
        SoftwareRenderer((16, 16)).render(verts, faces)


def test_failed_compile_raises_with_its_output(monkeypatch, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in host_lib.SOURCES:
        (src / name).write_text("this is not C++\n")
    monkeypatch.setattr(host_lib, "SRC_DIR", src)
    monkeypatch.setattr(host_lib, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(host_lib, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        mc.marching_tets_native(sphere_field(8, 0.3), 0.0)


def test_host_sources_match_the_jax_packages():
    """The port's copies under animnerf_tpu_torch/native/ hold the JAX
    package's native/ code line for line (comments aside)."""
    import pathlib

    pkg = pathlib.Path(mc.__file__).resolve().parents[1]

    def code(path):
        return [ln for ln in path.read_text().splitlines()
                if not ln.lstrip().startswith("//")]

    for name in host_lib.SOURCES:
        assert code(pkg / "native" / name) == code(
            pkg.parent / "native" / name), name


# ------------------------------------------------------------ rasterizer


def _triangle():
    """tests/test_components.py's triangle, 2 m in front of the camera."""
    verts = np.array([[-0.5, -0.5, 2.0], [0.5, -0.5, 2.0], [0.0, 0.6, 2.0]])
    return verts, np.array([[0, 1, 2]])


def _two_triangles():
    verts, _ = _triangle()
    return (np.concatenate([verts, verts * [0.5, 0.5, 0.5]]),
            np.array([[0, 1, 2], [3, 4, 5]]))


@pytest.mark.parametrize("mesh, color", [
    (_triangle, (0.65, 0.74, 0.86)), (_two_triangles, (1.0, 0.0, 0.0))])
def test_rasterizer_bit_equal_to_jax(mesh, color, monkeypatch):
    """The native fill against the numpy fill, and each against the JAX
    package's renderer (native, then with its native library made to fail
    so that it takes its numpy path), bit for bit."""
    from animnerf_tpu.utils import native_build
    from animnerf_tpu.utils.renderer import SoftwareRenderer as JaxRenderer
    from animnerf_tpu_torch.utils.renderer import SoftwareRenderer

    verts, faces = mesh()
    r = SoftwareRenderer((64, 64), bg_color=(0, 0, 0))
    r.set_camera(64, 64, 32, 32, np.eye(3), np.zeros(3))
    j = JaxRenderer((64, 64), bg_color=(0, 0, 0))
    j.set_camera(64, 64, 32, 32, np.eye(3), np.zeros(3))
    inputs = r.project(verts, faces, color=color)
    native = r.fill_native(*inputs)
    plain = r.fill_numpy(*inputs)
    assert (native.sum(-1) > 0).mean() > 0.05
    np.testing.assert_array_equal(native, plain)
    np.testing.assert_array_equal(r.render(verts, faces, color=color),
                                  native)
    np.testing.assert_array_equal(native, j.render(verts, faces,
                                                   color=color))
    with pytest.raises(ValueError, match="fill_native"):
        r.fill_native(inputs[0][:, :2], *inputs[1:])

    def broken(name):
        raise OSError("no toolchain")

    monkeypatch.setattr(native_build, "load_library", broken)
    np.testing.assert_array_equal(plain, j.render(verts, faces, color=color))


def test_rasterizer_turntable_bit_equal_to_jax():
    """A sphere mesh rotated as the mesh CLI's turntable does, against the
    JAX package's renderer (both native)."""
    from animnerf_tpu.utils.renderer import SoftwareRenderer as JaxRenderer
    from animnerf_tpu_torch.utils.renderer import SoftwareRenderer

    v, f = mc.marching_tets_native(sphere_field(16, 0.3), 0.0)
    v = v / 16.0 - 0.5 + np.array([0.0, 0.0, 2.0], np.float32)
    r, j = SoftwareRenderer((48, 40)), JaxRenderer((48, 40))
    for x in (r, j):
        x.set_camera(50, 52, 20, 24, np.eye(3), np.array([0.1, 0.0, 0.2]))
    for angle in (0.0, -90.0, -200.0):
        np.testing.assert_array_equal(r.render(v, f, angle=angle),
                                      j.render(v, f, angle=angle))


def test_weak_perspective_camera_bit_equal_to_jax():
    from animnerf_tpu.utils.renderer import WeakPerspectiveCamera as JaxCam
    from animnerf_tpu_torch.utils.renderer import WeakPerspectiveCamera

    pts = np.random.default_rng(2).normal(size=(50, 3))
    for scale, trans in (([0.9], [0.1, -0.2]), ([0.8, 1.1], [0.0, 0.3])):
        np.testing.assert_array_equal(
            WeakPerspectiveCamera(scale, trans).project(pts, (64, 48)),
            JaxCam(scale, trans).project(pts, (64, 48)))


# ------------------------------------------------------------------- GIF


def _frames(n=3, h=48, w=96):
    """Render-like frames: smooth gradients, a jet band, flat background
    and some noise."""
    from animnerf_tpu_torch.utils.image import apply_jet

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        img = np.stack([(xx * 255 / w + 20 * i) % 256, yy * 255 / h,
                        127 + 60 * np.sin(xx / 9.0 + i)], -1)
        img = np.clip(img + rng.normal(0, 3, img.shape), 0, 255)
        img = img.astype(np.uint8)
        img[:, w // 2:] = apply_jet(((xx + yy + 7 * i) % 256).astype(
            np.uint8))[:, w // 2:]
        img[: h // 4] = 255
        out.append(img)
    return out


def _decode(data):
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    frames, delays = [], []
    for k in range(im.n_frames):
        im.seek(k)
        frames.append(np.asarray(im.convert("RGB")))
        delays.append(im.info.get("duration"))
    return frames, delays


def test_gif_against_imageio(tmp_path):
    """PIL decodes the port's GIF: the frame count, the frame delay of
    fps=30 (as imageio.mimsave writes it) and a mean absolute error
    against the input frames at most 1.5x that of imageio.mimsave's GIF
    of the same frames."""
    import imageio

    from animnerf_tpu_torch.utils.image import write_gif

    frames = _frames()
    ours = tmp_path / "ours.gif"
    theirs = tmp_path / "theirs.gif"
    write_gif(str(ours), frames, fps=30)
    imageio.mimsave(str(theirs), frames, fps=30)
    dec, delays = _decode(ours.read_bytes())
    ref, ref_delays = _decode(theirs.read_bytes())
    assert len(dec) == len(ref) == len(frames)
    assert delays == ref_delays == [30] * len(frames)

    def mae(got):
        return float(np.mean([np.abs(a.astype(np.int32) - b).mean()
                              for a, b in zip(got, frames)]))

    assert mae(dec) <= 1.5 * mae(ref), (mae(dec), mae(ref))
    # imageio's own reader takes it too
    assert len(imageio.mimread(str(ours))) == len(frames)


def test_gif_exact_for_few_colours_and_long_frames():
    """Frames of at most 256 colours decode exactly, also where a frame
    is longer than many clear-code runs and its pixel count is not a
    multiple of the run."""
    from animnerf_tpu_torch.utils.image import encode_gif

    rng = np.random.default_rng(1)
    palette = rng.integers(0, 256, (200, 3), dtype=np.uint8)
    frames = [palette[rng.integers(0, 200, (37, 53))] for _ in range(2)]
    dec, _ = _decode(encode_gif(frames, fps=10))
    for a, b in zip(dec, frames):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_chip_smoke_marching_check_on_the_cpu(name):
    """chip_smoke.py's check of the native marching against
    marching_tets_numpy: its numpy model of the native merge reproduces
    this build's vertices and triangles bit for bit, and its soup is
    marching_tets_numpy's after sorting the triangles."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    line = cs.marching_check(FIELDS[name]())
    assert line["soup_bit_equal"] and line["merge_bit_equal"]
    assert line["triangles"] > 100
