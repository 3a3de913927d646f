"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by its own ``nvcc`` process for ``sm_90a`` (all
started together), then linked into one shared library with a plain C
interface that ``ctypes`` loads. The library lands in
``build/animnerf_tpu_torch/<hash>/`` at the repository root, keyed by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once. No fast-math: the kernels reproduce the JAX
package's rounding (see each source's note).

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; the wrappers raise on a non-zero code. A wrapper
adds one to its entry in ``LAUNCHES`` (``utils/trace.py``) each time it
launches its kernel, so a run can show that the main path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

# the launch counts live with the tracer (``utils/trace.py``), which adds
# each call's launches to its record; the same dict object is re-exported
from animnerf_tpu_torch.utils.trace import (  # noqa: F401
    LAUNCHES,
    reset_launches,
)

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "animnerf_tpu_torch"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
SOURCES = ("knn.cu", "warp_blend.cu", "fused_mlp.cu", "sort_lanes.cu",
           "scatter.cu", "fused_mlp_bwd.cu", "knn_exact.cu", "min_dist.cu",
           "knn_packed.cu", "knn_mxu.cu", "mlp_wgrad.cu", "knn_far.cu",
           "mlp_f32.cu")
# device code the sources include (hashed with them)
HEADERS = ("knn_keys.cuh", "knn_slots.cuh", "knn_sweep.cuh", "knn_wide.cuh",
           "mlp_wgmma.cuh", "mlp_bwd_layout.cuh", "mlp_f32_tile.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]
LIB_NAME = "libanimnerf_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every function returns cudaGetLastError() as an int
SIGNATURES = {
    "animnerf_knn_rows": [_P, _P, _P, _I, _I, _I, _I, _P],
    "animnerf_knn_top4": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                          _I, _P],
    "animnerf_warp_blend_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _F, _F, _I, _I, _P],
    "animnerf_warp_blend_group_max_k": [_I, _P],
    "animnerf_fused_mlp_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _P],
    "animnerf_gather_lanes": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "animnerf_weighted_scatter": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _P],
    "animnerf_fused_mlp_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _I, _I, _I, _I, _I, _P],
    "animnerf_fused_mlp_bwd_sizes": [_I, _I, _P],
    "animnerf_mlp_wgrad": [_P, _P, _P, _P, _I, _I, _I, _P],
    "animnerf_mlp_f32_smem": [_I, _I, _P],
    "animnerf_knn_exact_rows": [_P, _P, _P, _P, _I, _I, _I, _P],
    "animnerf_knn_exact": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _P],
    "animnerf_knn_exact_wide": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _P],
    "animnerf_min_dist": [_P, _P, _P, _I, _I, _I, _P],
    "animnerf_knn_packed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P],
    "animnerf_knn_packed_wide": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _P],
    "animnerf_knn_far": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    "animnerf_knn_mxu": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _P],
    "animnerf_knn_mxu_codes": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "animnerf_knn_mxu_pack": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _P, _I, _I, _I, _I, _P],
}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then PATH, then the default CUDA prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc (the CUDA compiler) was not found in $CUDA_HOME/bin, on PATH "
        f"or in {DEFAULT_CUDA_HOME}/bin: the port's kernels are built from "
        "animnerf_tpu_torch/csrc at first use and need it")


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(ARCH + NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The built shared library and what its build reported."""

    def __init__(self, path: Path, seconds: float, cached: bool, log: str):
        self.path = path
        self.seconds = seconds
        self.cached = cached
        self.log = log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _build(out_dir: Path) -> str:
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=out_dir))
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (name + ".o")
            cmd = [nvcc, *ARCH, *NVCC_FLAGS, "-c", str(CSRC / name),
                   "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs, objs, failed = [], [], []
        for name, obj, p in procs:
            out, err = p.communicate()
            logs.append(f"== {name}\n{out}{err}")
            objs.append(str(obj))
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib_tmp = tmp / LIB_NAME
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(lib_tmp),
                               *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(lib_tmp, out_dir / LIB_NAME)
        log = "\n".join(logs)
        (out_dir / "build.log").write_text(log)
        return log
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


_LIBRARY: Optional[KernelLibrary] = None


def kernel_library() -> KernelLibrary:
    """Build (if the sources changed) and load the kernels, once per
    process. Raises with nvcc's output when a build fails."""
    global _LIBRARY
    if _LIBRARY is None:
        out_dir = BUILD_ROOT / source_hash()
        t0 = time.perf_counter()
        if (out_dir / LIB_NAME).is_file():
            log_file = out_dir / "build.log"
            log = log_file.read_text() if log_file.is_file() else ""
            cached = True
        else:
            log = _build(out_dir)
            cached = False
        _LIBRARY = KernelLibrary(out_dir / LIB_NAME,
                                 time.perf_counter() - t0, cached, log)
    return _LIBRARY


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, *tensors) -> None:
    """Kernel inputs must be contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
