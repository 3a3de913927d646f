"""The port package stands alone: no JAX, no ``animnerf_tpu`` imports; its
entry points refuse to run on the CPU unless asked; CPU tensors take the
plain versions; a missing nvcc is reported by name."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PKG = pathlib.Path(__file__).resolve().parents[1] / "animnerf_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "animnerf_tpu")
# the card's machine has none of these (yaml is imported only to read a
# YAML config and h5py only to read a People-Snapshot release, so they are
# banned at import time alone)
NOT_ON_THE_CARD = ("cv2", "PIL", "imageio")
IMPORT_TIME_BAN = ("yaml", "h5py")


def test_import_loads_no_jax():
    code = ("import sys, animnerf_tpu_torch.render.inference, "
            "animnerf_tpu_torch.utils.convert, animnerf_tpu_torch.data.synthetic,"
            " animnerf_tpu_torch.training.system,"
            " animnerf_tpu_torch.render.compact_rows,"
            " animnerf_tpu_torch.ops.perm_sort, animnerf_tpu_torch.utils.rng,"
            " animnerf_tpu_torch.ops.knn_mxu,"
            " animnerf_tpu_torch.tools.bench_knn,"
            " animnerf_tpu_torch.cli.common, animnerf_tpu_torch.cli.novel_view,"
            " animnerf_tpu_torch.cli.novel_pose,"
            " animnerf_tpu_torch.cli.extract_mesh,"
            " animnerf_tpu_torch.ops.marching,"
            " animnerf_tpu_torch.utils.renderer,"
            " animnerf_tpu_torch.utils.host_lib,"
            " animnerf_tpu_torch.models.lpips,"
            " animnerf_tpu_torch.models.evaluator,"
            " animnerf_tpu_torch.tools.vibe,"
            " animnerf_tpu_torch.tools.convert_vibe,"
            " animnerf_tpu_torch.tools.vibe_driver,"
            " animnerf_tpu_torch.tools.rvm;"
            "bad = [m for m in sys.modules if m.split('.')[0] in %r];"
            "print(bad); sys.exit(1 if bad else 0)" % (FORBIDDEN,))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=PKG.parent, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_importing_every_module_loads_no_jax_cv2_pil_imageio_or_yaml():
    """Every port module and chip_smoke.py import in a fresh interpreter
    without loading JAX, the JAX package, OpenCV, PIL, imageio, PyYAML or
    h5py (the card's machine has none of the last five; yaml is imported
    only to read a YAML config, h5py only inside the People-Snapshot
    tool's ``prepare``)."""
    banned = FORBIDDEN + NOT_ON_THE_CARD + IMPORT_TIME_BAN
    code = (
        "import importlib, pkgutil, sys, animnerf_tpu_torch as p;"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'animnerf_tpu_torch.')];"
        "[importlib.import_module(m) for m in mods];"
        "import importlib.util as u;"
        "spec = u.spec_from_file_location('chip_smoke', 'chip_smoke.py');"
        "spec.loader.exec_module(u.module_from_spec(spec));"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r];"
        "print(len(mods), bad); sys.exit(1 if bad or len(mods) < 40 else 0)"
        % (banned,))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=PKG.parent, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_jax_or_the_jax_package(path):
    """Also inside functions: no JAX, no JAX package, and none of the
    image libraries the card's machine lacks."""
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN + NOT_ON_THE_CARD]
    assert not bad, f"{path.name} imports {bad}"


def test_chip_smoke_imports_nothing_the_card_lacks():
    root = PKG.parent / "chip_smoke.py"
    bad = [m for m in _imports(root)
           if m.split(".")[0] in FORBIDDEN + NOT_ON_THE_CARD
           + IMPORT_TIME_BAN]
    assert not bad, f"chip_smoke.py imports {bad}"


def test_host_library_builds_the_ports_own_sources():
    """The host C++ (marching, raster) comes from the port's copies under
    animnerf_tpu_torch/native/, never from the JAX package's native/, and
    builds under build/animnerf_tpu_torch/."""
    from animnerf_tpu_torch.utils import host_lib

    assert host_lib.SRC_DIR == PKG / "native"
    assert host_lib.BUILD_ROOT == PKG.parent / "build" / "animnerf_tpu_torch"
    assert sorted(host_lib.SOURCES) == sorted(
        p.name for p in (PKG / "native").glob("*.cpp"))
    for name in host_lib.SOURCES:
        assert (PKG / "native" / name).is_file()
    text = (PKG / "utils" / "host_lib.py").read_text()
    assert "native_build" not in text and "animnerf_tpu/" not in text


def _tiny_system():
    from animnerf_tpu_torch.data.synthetic import make_body_model
    from animnerf_tpu_torch.system import AnimNeRFSystem

    return AnimNeRFSystem({"n_samples": 8, "n_importance": 4},
                          make_body_model(64, 8, seed=1), device="cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from animnerf_tpu_torch.render.inference import Renderer
    from animnerf_tpu_torch.utils.device import resolve_device

    system = _tiny_system()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(system)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert Renderer(system, device="cpu").device.type == "cpu"


def test_prep_tools_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    """The template tool resolves its device before it reads anything: no
    card and no "cpu" raises."""
    from animnerf_tpu_torch.tools.prepare_template import prepare_template

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prepare_template(str(tmp_path), "subj", template_path="missing.pkl")


def test_missing_nvcc_is_named(monkeypatch, tmp_path):
    from animnerf_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBRARY", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.kernel_library()


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """No build and no launch count on CPU tensors."""
    from animnerf_tpu_torch.models.nerf import NeRFMLP
    from animnerf_tpu_torch.ops import _build
    from animnerf_tpu_torch.ops.blend import weighted_scatter_rows
    from animnerf_tpu_torch.ops.fused_mlp import (
        fused_nerf_bwd,
        fused_nerf_fwd,
        pack_params,
    )
    from animnerf_tpu_torch.ops.knn import min_vertex_distance
    from animnerf_tpu_torch.ops.knn_kernel import (
        knn,
        knn_exact,
        knn_packed,
        knn_top4,
    )
    from animnerf_tpu_torch.ops.knn_mxu import knn_mxu
    from animnerf_tpu_torch.ops.sort_lanes import permute_lanes

    def no_build():
        raise AssertionError("a CPU tensor must not build the kernels")

    monkeypatch.setattr(_build, "kernel_library", no_build)
    _build.reset_launches()
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.normal(size=(1, 50, 3)).astype(np.float32))
    knn_top4(pts, pts[:, :20].contiguous())
    knn_top4(pts, pts[:, :20].contiguous(), tile_skip=True)
    knn_exact(pts, pts[:, :20].contiguous())
    knn(pts, pts[:, :20].contiguous(), packed=False)
    knn_packed(pts, pts[:, :20].contiguous(), 8)
    knn_exact(pts, pts[:, :20].contiguous(), 8)
    knn(pts, pts[:, :20].contiguous(), 2)
    for prec in ("highest", "default"):
        knn_mxu(pts, pts[:, :20].contiguous(), precision=prec)
    min_vertex_distance(pts, pts[:, :20].contiguous())
    ws, bs = pack_params(NeRFMLP(4).state_dict(), 4, "float32")
    fused_nerf_fwd(torch.zeros(1, 8, 10), ws, bs, 4, "float32")
    fused_nerf_bwd(torch.zeros(1, 8, 10), ws, bs, torch.ones(1, 8, 10), 4,
                   "float32")
    weighted_scatter_rows(torch.zeros(1, 4, 10, dtype=torch.int32),
                          torch.ones(1, 4, 10), torch.ones(1, 16, 10), 5)
    weighted_scatter_rows(torch.zeros(1, 8, 10, dtype=torch.int32),
                          torch.ones(1, 8, 10), torch.ones(1, 16, 10), 5)
    permute_lanes(torch.zeros(1, 2, 3, 128),
                  torch.arange(128, dtype=torch.int32).expand(1, 3, 128))
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_build_hash_covers_every_source():
    from animnerf_tpu_torch.ops import _build

    assert sorted(_build.SOURCES) == sorted(
        p.name for p in _build.CSRC.glob("*.cu"))
    assert sorted(_build.HEADERS) == sorted(
        p.name for p in _build.CSRC.glob("*.cuh"))
    assert set(_build.LAUNCHES) >= {"knn", "knn_packed", "knn_exact",
                                    "knn_mxu", "warp_blend", "scatter"}
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert len(_build.source_hash()) == 16
