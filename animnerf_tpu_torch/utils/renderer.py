"""Offscreen mesh rasterizer (SMPL overlays, mesh turntables) —
counterpart of ``animnerf_tpu/utils/renderer.py``.

A z-buffer software rasterizer in place of the reference's pyrender+EGL
renderer: the same camera convention (intrinsics fx/fy/cx/cy with the
reference's R/t world->camera and y/z flip) and API (set_camera /
render(verts, faces, angle, axis)), Lambertian shading with three
directional lights. The pixel fill runs in the port's host library
(``native/rasterizer.cpp``, built at first use); unlike the JAX package's
renderer it raises when that library cannot be built instead of falling
back to the numpy fill, which stays as its own method (``fill_numpy``)
for the tests.
"""

from __future__ import annotations

import math

import numpy as np

from animnerf_tpu_torch.utils.host_lib import host_library

EPS = 1e-6


class WeakPerspectiveCamera:
    """Weak-perspective camera (reference utils/renderer.py keeps one for
    VIBE-style sx/sy/tx/ty cameras)."""

    def __init__(self, scale, translation, znear=0.05, zfar=100.0):
        self.scale = np.asarray(scale, np.float64).reshape(-1)
        self.translation = np.asarray(translation, np.float64).reshape(-1)
        self.znear, self.zfar = znear, zfar

    def project(self, points: np.ndarray, img_wh) -> np.ndarray:
        W, H = img_wh
        sx = self.scale[0]
        sy = self.scale[1] if self.scale.size > 1 else self.scale[0]
        x = (points[:, 0] + self.translation[0]) * sx
        y = (points[:, 1] + self.translation[1]) * sy
        u = (x + 1.0) * 0.5 * W
        v = (1.0 - (y + 1.0) * 0.5) * H
        return np.stack([u, v], axis=-1)


def _rotation(angle_deg: float, axis) -> np.ndarray:
    a = math.radians(angle_deg)
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n == 0:
        return np.eye(3)
    x, y, z = axis / n
    c, s = math.cos(a), math.sin(a)
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return np.eye(3) + s * K + (1 - c) * (K @ K)


class SoftwareRenderer:
    def __init__(self, resolution=(512, 512), bg_color=(255, 255, 255)):
        self.H, self.W = resolution
        self.bg = np.asarray(bg_color, np.uint8)
        self.fx = self.fy = float(max(resolution))
        self.cx, self.cy = self.W / 2.0, self.H / 2.0
        self.R = np.eye(3)
        self.t = np.zeros(3)
        # three directional lights (raymond rig analogue)
        phi = [0.0, 2 * np.pi / 3, 4 * np.pi / 3]
        self.lights = np.stack(
            [np.array([np.cos(p), np.sin(p), 1.0]) / np.sqrt(2.0)
             for p in phi])
        self.light_intensity = np.array([0.45, 0.3, 0.3])

    def set_camera(self, fx, fy, cx, cy, R=None, t=None):
        self.fx, self.fy, self.cx, self.cy = float(fx), float(fy), float(cx), float(cy)
        if R is not None:
            self.R = np.asarray(R, np.float64)
        if t is not None:
            self.t = np.asarray(t, np.float64).reshape(3)

    def project(self, vertices: np.ndarray, faces: np.ndarray,
                angle: float = 0.0, axis=(0, 1, 0),
                color=(0.65, 0.74, 0.86)):
        """The fill's inputs: per-face screen coordinates (F, 3, 2), camera
        depths (F, 3) and flat-shaded colours (F, 3) float; ``angle`` /
        ``axis`` rotate the mesh about its centroid (turntable)."""
        v = np.asarray(vertices, np.float64)
        f = np.asarray(faces, np.int64)
        if angle != 0.0:
            c = v.mean(0)
            v = (v - c) @ _rotation(angle, axis).T + c

        # world -> camera (reference convention: flip y/z after R|t)
        vc = v @ self.R.T + self.t
        vc = vc * np.array([1.0, -1.0, -1.0])
        # camera looks along -z after the flip; keep points with z<0 in front
        z = -vc[:, 2]
        u = self.fx * vc[:, 0] / np.maximum(z, EPS) + self.cx
        w = self.cy - self.fy * vc[:, 1] / np.maximum(z, EPS)

        tri_uv = np.stack([u[f], w[f]], axis=-1)  # (F, 3, 2)
        tri_z = z[f]                               # (F, 3)

        # flat shading from world-space normals
        e1 = v[f[:, 1]] - v[f[:, 0]]
        e2 = v[f[:, 2]] - v[f[:, 0]]
        n = np.cross(e1, e2)
        n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
        shade = 0.25 + np.clip(n @ self.lights.T, 0, 1) @ self.light_intensity
        shade = np.clip(shade, 0, 1)
        return tri_uv, tri_z, np.asarray(color)[None] * shade[:, None]

    def _canvas(self):
        img = np.tile(self.bg, (self.H, self.W, 1)).astype(np.uint8)
        return img, np.full((self.H, self.W), np.inf)

    def render(self, vertices: np.ndarray, faces: np.ndarray,
               angle: float = 0.0, axis=(0, 1, 0),
               color=(0.65, 0.74, 0.86)) -> np.ndarray:
        """Rasterize -> (H, W, 3) uint8 RGB through the native fill."""
        return self.fill_native(*self.project(vertices, faces, angle, axis,
                                              color))

    def fill_native(self, tri_uv, tri_z, colors) -> np.ndarray:
        """The pixel fill in ``native/rasterizer.cpp`` (float32)."""
        lib = host_library()
        img, zbuf = self._canvas()
        cols = np.ascontiguousarray(
            np.clip(colors * 255, 0, 255).astype(np.uint8))
        uv = np.ascontiguousarray(tri_uv, np.float32)
        zz = np.ascontiguousarray(tri_z, np.float32)
        zb = np.ascontiguousarray(zbuf, np.float32)
        n = len(zz)
        if uv.shape != (n, 3, 2) or zz.shape != (n, 3) or cols.shape != (n, 3):
            raise ValueError(f"fill_native: uv {uv.shape}, z {zz.shape}, "
                             f"colors {cols.shape} for {n} faces")
        rc = lib.raster_fill(uv.ctypes.data, zz.ctypes.data,
                             cols.ctypes.data, n, self.H, self.W,
                             img.ctypes.data, zb.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"raster_fill rc={rc}")
        return img

    def fill_numpy(self, tri_uv, tri_z, colors) -> np.ndarray:
        """The JAX package's numpy fill (float64, far-to-near order)."""
        img, zbuf = self._canvas()
        order = np.argsort(-tri_z.mean(1))  # far-to-near helps early z-fail
        Hh, Ww = self.H, self.W
        for fi in order:
            if (tri_z[fi] <= EPS).any():
                continue
            uv = tri_uv[fi]
            x0, y0 = uv.min(0)
            x1, y1 = uv.max(0)
            ix0, iy0 = max(int(x0), 0), max(int(y0), 0)
            ix1, iy1 = min(int(x1) + 1, Ww), min(int(y1) + 1, Hh)
            if ix0 >= ix1 or iy0 >= iy1:
                continue
            xs, ys = np.meshgrid(np.arange(ix0, ix1) + 0.5,
                                 np.arange(iy0, iy1) + 0.5)
            a, b, c = uv
            det = (b[0] - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (b[1] - a[1])
            if abs(det) < 1e-12:
                continue
            l1 = ((xs - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (ys - a[1])) / det
            l2 = ((b[0] - a[0]) * (ys - a[1]) - (xs - a[0]) * (b[1] - a[1])) / det
            l0 = 1.0 - l1 - l2
            inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
            if not inside.any():
                continue
            # perspective-correct depth via 1/z interpolation
            zi = 1.0 / (l0 / tri_z[fi, 0] + l1 / tri_z[fi, 1]
                        + l2 / tri_z[fi, 2] + 1e-12)
            win_z = zbuf[iy0:iy1, ix0:ix1]
            visible = inside & (zi < win_z)
            if not visible.any():
                continue
            win_z[visible] = zi[visible]
            col = np.clip(colors[fi] * 255, 0, 255).astype(np.uint8)
            img[iy0:iy1, ix0:ix1][visible] = col
        return img
