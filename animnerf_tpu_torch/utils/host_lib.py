"""Build and load the port's host C++ library (``native/*.cpp``) at first
use: the marching tetrahedra of mesh extraction (``ops/marching.py``) and
the rasterizer's pixel fill (``utils/renderer.py``).

The sources are the port's own copies under ``animnerf_tpu_torch/native/``.
They are compiled with ``g++ -O3 -shared -fPIC -std=c++17`` into one
shared library in ``build/animnerf_tpu_torch/host-<hash>/`` at the
repository root, keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once. A failed build raises
with the compiler's output: no caller falls back to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "native"
BUILD_ROOT = _PKG.parent / "build" / "animnerf_tpu_torch"
SOURCES = ("marching_tets.cpp", "rasterizer.cpp")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIB_NAME = "libanimnerf_host.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
SIGNATURES = {
    "mt_run": ([_P, _I, _I, _I, ctypes.c_float, _P, _P, _P, _P], _I),
    "mt_free": ([_P], None),
    "raster_fill": ([_P, _P, _P, _LL, _I, _I, _P, _P], _I),
}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def source_hash(src_dir: Path) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((src_dir / name).read_bytes())
    return h.hexdigest()[:16]


def _build(src_dir: Path, out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=out_dir))
    try:
        lib_tmp = tmp / LIB_NAME
        r = subprocess.run(["g++", *FLAGS, *(str(src_dir / s)
                                             for s in SOURCES),
                            "-o", str(lib_tmp)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCES}:\n{r.stdout}"
                               f"{r.stderr}")
        os.replace(lib_tmp, out_dir / LIB_NAME)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def host_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the host library, once per
    process. Raises when a source is missing or g++ fails."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            out_dir = BUILD_ROOT / f"host-{source_hash(SRC_DIR)}"
            if not (out_dir / LIB_NAME).is_file():
                _build(SRC_DIR, out_dir)
            lib = ctypes.CDLL(str(out_dir / LIB_NAME))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIB = lib
        return _LIB
