"""Isosurface extraction: native marching tetrahedra, its numpy twin and
``smooth`` — counterpart of ``animnerf_tpu/ops/marching.py``.

``marching_tets_native`` runs ``native/marching_tets.cpp`` from the port's
host library (``utils/host_lib.py``, built with g++ at first use). It
merges the vertices shared between tetrahedra, so the mesh is watertight.
``marching_tets_numpy`` is the vectorised numpy version of the same
decomposition and orientation with one vertex per emitted corner (a
triangle soup): the cross-check of the native version, reached only by
name. ``marching_cubes`` is the native version; unlike the JAX package's
it raises when the build or the call fails instead of falling back to
numpy. ``smooth`` is the JAX package's analogue of ``mcubes.smooth``:
the gaussian-filtered signed occupancy.
"""

from __future__ import annotations

import ctypes

import numpy as np

from animnerf_tpu_torch.utils.host_lib import host_library

_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 3, 6], [0, 3, 2, 6],
    [0, 2, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
], dtype=np.int32)

_CORNERS = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)],
                    dtype=np.int32)


def marching_tets_native(field: np.ndarray, iso: float = 0.0):
    """(nx, ny, nz) field -> (vertices (V, 3) float32 in grid-index
    coordinates, triangles (T, 3) int32), inside = below iso."""
    lib = host_library()
    f = np.ascontiguousarray(field, dtype=np.float32)
    nx, ny, nz = f.shape
    vp = ctypes.POINTER(ctypes.c_float)()
    tp = ctypes.POINTER(ctypes.c_int)()
    nv = ctypes.c_longlong()
    nt = ctypes.c_longlong()
    rc = lib.mt_run(f.ctypes.data, nx, ny, nz, ctypes.c_float(iso),
                    ctypes.byref(vp), ctypes.byref(nv),
                    ctypes.byref(tp), ctypes.byref(nt))
    if rc != 0:
        raise RuntimeError(f"mt_run failed with code {rc}")
    try:
        verts = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy() \
            if nv.value else np.zeros((0, 3), np.float32)
        tris = np.ctypeslib.as_array(tp, shape=(nt.value, 3)).copy() \
            if nt.value else np.zeros((0, 3), np.int32)
    finally:
        lib.mt_free(vp)
        lib.mt_free(tp)
    return verts, tris


def marching_tets_numpy(field: np.ndarray, iso: float = 0.0):
    """Vectorized numpy marching tetrahedra (same decomposition/orientation
    as the native kernel; vertices unmerged)."""
    f = np.asarray(field, np.float32)
    nx, ny, nz = f.shape
    ii, jj, kk = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    base = np.stack([ii, jj, kk], -1).reshape(-1, 3)  # (C, 3)

    corner_pos = base[:, None, :] + _CORNERS[None]      # (C, 8, 3)
    vals = f[corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]]

    verts_out, tris_out = [], []
    nvert = 0
    for tet in _TETS:
        p = corner_pos[:, tet]            # (C, 4, 3)
        v = vals[:, tet]                  # (C, 4)
        inside = v < iso                  # (C, 4)
        ni = inside.sum(1)

        def emit_edge(sel, a_idx, b_idx):
            pa = p[sel][np.arange(sel.sum()), a_idx]
            pb = p[sel][np.arange(sel.sum()), b_idx]
            va = v[sel][np.arange(sel.sum()), a_idx]
            vb = v[sel][np.arange(sel.sum()), b_idx]
            denom = vb - va
            t = np.where(denom != 0, (iso - va) / np.where(denom == 0, 1, denom),
                         0.5)
            t = np.clip(t, 0, 1)[:, None]
            return pa + t * (pb - pa)

        def ordered(sel, want_inside, n):
            m = inside[sel] if want_inside else ~inside[sel]
            return np.argsort(~m, axis=1, kind="stable")[:, :n]

        for count, flip in ((1, False), (3, True)):
            sel = ni == count
            if not sel.any():
                continue
            apex = ordered(sel, count == 1, 1)[:, 0]
            others = ordered(sel, count != 1, 3)
            tri = [emit_edge(sel, apex, others[:, c]) for c in range(3)]
            tri = np.stack(tri, axis=1)  # (S, 3, 3)
            if flip:
                tri = tri[:, [0, 2, 1]]
            s = tri.shape[0]
            verts_out.append(tri.reshape(-1, 3))
            tris_out.append(nvert + np.arange(3 * s).reshape(s, 3))
            nvert += 3 * s

        sel = ni == 2
        if sel.any():
            ins = ordered(sel, True, 2)
            outs = ordered(sel, False, 2)
            a = emit_edge(sel, ins[:, 0], outs[:, 0])
            b = emit_edge(sel, ins[:, 0], outs[:, 1])
            c = emit_edge(sel, ins[:, 1], outs[:, 1])
            d = emit_edge(sel, ins[:, 1], outs[:, 0])
            s = a.shape[0]
            quad = np.stack([a, b, c, a, c, d], axis=1).reshape(-1, 3)
            verts_out.append(quad)
            tris_out.append(nvert + np.arange(6 * s).reshape(2 * s, 3))
            nvert += 6 * s

    if not verts_out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    return (np.concatenate(verts_out).astype(np.float32),
            np.concatenate(tris_out).astype(np.int32))


def marching_cubes(field: np.ndarray, iso: float = 0.0):
    """Isosurface of ``field`` at ``iso`` (PyMCubes.marching_cubes
    analogue; surface where field crosses iso, inside = below): the
    native version, which raises if it cannot be built or run."""
    return marching_tets_native(field, iso)


def smooth(field: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """mcubes.smooth analogue: signed, smoothed occupancy (positive inside)."""
    from scipy import ndimage

    occ = (np.asarray(field) > 0).astype(np.float32) - 0.5
    return ndimage.gaussian_filter(occ, sigma=sigma)
