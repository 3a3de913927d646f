"""The port's reference-checkpoint route against the JAX package's, on the
CPU: ``utils/torch_pickle.py`` (a restricted unpickler),
``tools/convert_checkpoint.py`` and ``tools/parity_check.py``.

A Lightning ``.ckpt`` is fabricated with ``torch.save``: reference
state-dict names, the SMPL-buffer / evaluator / LPIPS decoys the
converter drops, and hyper-parameters holding an instance of a class
from a module that exists only while the file is written (as yacs'
``CfgNode`` does not exist on the card's machine). Bounds: every
converted array bit-equal to the JAX converter's, the same groups and
``meta["cfg"]``; the parity check's PSNR within 1e-4 dB of the JAX
tool's on the same assets.
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from animnerf_tpu_torch.tools.convert_checkpoint import convert, map_mlp_key
from animnerf_tpu_torch.utils.torch_pickle import (
    Placeholder,
    load_torch_checkpoint,
)

sys.path.insert(0, os.path.dirname(__file__))

torch.set_num_threads(1)

GONE = "reference_cfg_module_not_on_this_machine"


def _save_with_gone_class(payload_fn, path):
    """torch.save(payload_fn(Cls), path) where Cls lives in a module that
    is registered only while the file is written."""
    mod = types.ModuleType(GONE)

    class CfgNode:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    CfgNode.__module__ = GONE
    CfgNode.__qualname__ = "CfgNode"
    mod.CfgNode = CfgNode
    sys.modules[GONE] = mod
    try:
        torch.save(payload_fn(CfgNode), path)
    finally:
        del sys.modules[GONE]


def _layer_name(layer: str) -> str:
    """Flax layer -> the reference module's attribute path."""
    if layer == "xyz_final":
        return "xyz_encoding_final"
    if layer == "dir_0":
        return "dir_encoding.0"
    if layer == "rgb":
        return "rgb.0"
    if layer in ("sigma", "out"):
        return layer
    return f"xyz_encoding_{int(layer[4:]) + 1}.0"


def _state_dict(rng):
    """Reference names for a NeRF, a fine NeRF and a DeRF (random
    weights, (out, in)), latent codes, body params, decoys."""
    sd = {}
    widths = {"xyz_0": (63, 256), "xyz_1": (256, 256), "xyz_final": (256, 256),
              "sigma": (256, 1), "dir_0": (256, 128), "rgb": (128, 3)}
    for net in ("nerf", "nerf_fine"):
        for layer, (i, o) in widths.items():
            tn = _layer_name(layer)
            sd[f"anim_nerf.{net}.{tn}.weight"] = torch.from_numpy(
                rng.normal(size=(o, i)).astype(np.float32))
            sd[f"anim_nerf.{net}.{tn}.bias"] = torch.from_numpy(
                rng.normal(size=o).astype(np.float32))
    for layer, (i, o) in {"xyz_0": (63, 128), "out": (128, 9)}.items():
        tn = _layer_name(layer)
        sd[f"anim_nerf.derf.{tn}.weight"] = torch.randn(o, i,
                                                        dtype=torch.float64)
        sd[f"anim_nerf.derf.{tn}.bias"] = torch.randn(o).to(torch.bfloat16)
    sd["latent_codes.weight"] = torch.randn(5, 16)
    sd["body_model_params.betas.weight"] = torch.randn(1, 10)
    sd["body_model_params.body_pose.weight"] = torch.randn(5, 69)
    sd["body_model_params.transl.weight"] = torch.randn(5, 3).half()
    # a strided (transposed) tensor and an offset view
    sd["body_model_params.global_orient.weight"] = torch.randn(3, 5).t()
    # decoys the converter drops
    sd["anim_nerf.body_model.v_template"] = torch.randn(10, 3)
    sd["anim_nerf.body_model.faces"] = torch.arange(30).reshape(10, 3)
    sd["evaluator.lpips.net.slice1.0.weight"] = torch.randn(4, 3, 3, 3)
    sd["anim_nerf.nerf.lpips.scale"] = torch.ones(3)
    sd["anim_nerf.other.weight"] = torch.ones(2)
    return sd


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    torch.manual_seed(0)
    path = str(tmp_path_factory.mktemp("ckpt") / "last.ckpt")
    sd = _state_dict(np.random.default_rng(0))
    _save_with_gone_class(lambda Cls: {
        "epoch": 3, "global_step": 99, "pytorch-lightning_version": "1.5.7",
        "state_dict": sd,
        "optimizer_states": [{"state": {}, "param_groups": []}],
        "hyper_parameters": {"exp_name": "p", "lr": 5e-4, "n_samples": 8,
                             "frame_IDs": [1, 2, 3], "img_wh": (24, 32),
                             "train": {"lr": 1e-3}, "none": None,
                             "cfg_node": Cls(a=1)}}, path)
    return path, sd


def test_reader_matches_the_jax_reader(ckpt):
    """Every tensor of the state dict as the JAX package's torch-free
    reader gives it (values, dtype, shape: float32 / float64 / float16 /
    bfloat16 widened to float32 / int64, a transposed view); plain
    entries equal; the unimportable class a Placeholder naming it."""
    from animnerf_tpu.utils.torch_pickle import load_torch_checkpoint as jl

    path, sd = ckpt
    got, want = load_torch_checkpoint(path), jl(path)
    assert sorted(got) == sorted(want)
    assert sorted(got["state_dict"]) == sorted(sd)
    for k, v in want["state_dict"].items():
        g = got["state_dict"][k]
        assert isinstance(g, np.ndarray) and g.dtype == v.dtype, k
        np.testing.assert_array_equal(g, v, err_msg=k)
        t = sd[k].float() if sd[k].dtype == torch.bfloat16 else sd[k]
        np.testing.assert_array_equal(g, t.numpy(), err_msg=k)
    assert got["epoch"] == 3 and got["global_step"] == 99
    hp = got["hyper_parameters"]
    node = hp.pop("cfg_node")
    assert isinstance(node, Placeholder)
    assert node._global == (GONE, "CfgNode") and node.state == {"a": 1}
    assert hp == {k: v for k, v in want["hyper_parameters"].items()
                  if k != "cfg_node"}


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_converter_matches_jax(ckpt, tmp_path):
    """The port's converter against animnerf_tpu.tools.convert_checkpoint:
    the same npz files, keys, dtypes and arrays bit for bit, the same
    meta.json (groups, cfg with the placeholder dropped, source); the
    kernels are the state dict's weights transposed, the decoys gone."""
    from animnerf_tpu.tools.convert_checkpoint import convert as jconvert

    path, sd = ckpt
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jconvert(path, jdir)
    assert convert(path, tdir) == tdir
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for f in os.listdir(jdir):
        if f.endswith(".npz"):
            a, b = _npz(os.path.join(jdir, f)), _npz(os.path.join(tdir, f))
            assert sorted(a) == sorted(b), f
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    with open(os.path.join(jdir, "meta.json")) as fj, \
            open(os.path.join(tdir, "meta.json")) as ft:
        mj, mt = json.load(fj), json.load(ft)
    assert mj == mt
    assert mt["groups"] == ["anim_nerf", "body_params", "latent_codes"]
    assert "cfg_node" not in mt["cfg"] and mt["cfg"]["n_samples"] == 8
    nerf = _npz(os.path.join(tdir, "anim_nerf.npz"))
    np.testing.assert_array_equal(
        nerf["nerf_fine/params/xyz_1/kernel"],
        sd["anim_nerf.nerf_fine.xyz_encoding_2.0.weight"].numpy().T)
    assert not any("lpips" in k or "body_model" in k or "other" in k
                   for k in nerf)
    np.testing.assert_array_equal(
        _npz(os.path.join(tdir, "latent_codes.npz"))[""],
        sd["latent_codes.weight"].numpy())
    assert map_mlp_key("out.weight") == ("out", "kernel")
    with pytest.raises(KeyError):
        map_mlp_key("view.weight")


class _Evil:
    def __init__(self, call, arg):
        self.call, self.arg = call, arg

    def __reduce__(self):
        return self.call, (self.arg,)


@pytest.mark.parametrize("call", ["os.system", "builtins.eval",
                                  "builtins.exec"])
def test_a_pickle_naming_code_runs_none(tmp_path, call):
    """A checkpoint whose pickle calls os.system / eval / exec loads
    without calling it: the global becomes a Placeholder holding the
    arguments; the tensors beside it load as usual."""
    import builtins

    marker = tmp_path / "ran"
    module, name = call.split(".")
    fn = getattr(os if module == "os" else builtins, name)
    code = (f"touch {marker}" if module == "os"
            else f"open({str(marker)!r}, 'w').close()")
    path = str(tmp_path / "evil.ckpt")
    torch.save({"state_dict": {"w": torch.ones(2, 2)},
                "hyper_parameters": {"x": _Evil(fn, code)}}, path)
    out = load_torch_checkpoint(path)
    assert not marker.exists()
    x = out["hyper_parameters"]["x"]
    assert isinstance(x, Placeholder) and x._global[1] == name
    assert x.args == (code,)
    np.testing.assert_array_equal(out["state_dict"]["w"], np.ones((2, 2)))
    convert(path, str(tmp_path / "conv"))
    assert not marker.exists()


def test_namespace_hparams_become_a_dict(tmp_path):
    """argparse.Namespace hyper-parameters (a reference run's args) load
    as the dict of their attributes and reach meta["cfg"]."""
    import argparse

    path = str(tmp_path / "ns.ckpt")
    torch.save({"state_dict": {}, "hyper_parameters": argparse.Namespace(
        n_samples=16, exp_name="ns")}, path)
    hp = load_torch_checkpoint(path)["hyper_parameters"]
    assert isinstance(hp, dict) and hp == {"n_samples": 16,
                                           "exp_name": "ns"}
    convert(path, str(tmp_path / "conv"))
    with open(tmp_path / "conv" / "meta.json") as f:
        assert json.load(f)["cfg"] == {"n_samples": 16, "exp_name": "ns"}


def test_not_a_zip_is_refused(tmp_path):
    path = tmp_path / "plain.pkl"
    with open(path, "wb") as f:
        pickle.dump({"a": 1}, f)
    with pytest.raises(Exception):
        load_torch_checkpoint(str(path))


def test_parity_check_matches_jax_end_to_end(tmp_path, capsys):
    """The parity chain on fabricated assets (tests/test_parity_check.py's,
    at a tiny size): a seeded SMPL pkl, a synthetic People-Snapshot release
    prepared by the port's tool, its template, a Lightning .ckpt of
    seeded weights under reference names with decoys; then the JAX
    run_parity_check and the port's on the CPU. The port's PSNR within
    1e-4 dB of the JAX tool's, its SSIM within 1e-4; deltas against the
    given reference numbers; no lpips key; the two command lines
    (convert_checkpoint, then parity_check on its directory) print the
    same report."""
    import jax

    from animnerf_tpu.tools.parity_check import run_parity_check as jrun
    from animnerf_tpu_torch.config import finalize, get_default_config
    from animnerf_tpu_torch.data.synthetic import make_rig
    from animnerf_tpu_torch.smpl.loader import save_model_data
    from animnerf_tpu_torch.training.loop import build_system
    from animnerf_tpu_torch.tools.parity_check import run_parity_check
    from animnerf_tpu_torch.tools.people_snapshot import prepare
    from animnerf_tpu_torch.tools.prepare_template import prepare_template
    from animnerf_tpu_torch.utils.io import write_pickle_file
    from test_torch_prep_tools import _fabricate_release, cv2_decoder

    H, W, F = 32, 24, 6
    smpl_pkl = str(tmp_path / "models" / "smpl" / "SMPL_MALE.pkl")
    os.makedirs(os.path.dirname(smpl_pkl))
    save_model_data(smpl_pkl, make_rig(num_verts=240, num_joints=24, seed=7))
    raw = tmp_path / "raw" / "male-9-parity"
    _fabricate_release(raw, H, W, F, (H, W), np.random.default_rng(11))
    data_dir = str(tmp_path / "data" / "male-9-parity")
    prepare(str(raw), data_dir, decoder=cv2_decoder)
    # the release's random poses, made small and in front of the camera
    for f in sorted(os.listdir(os.path.join(data_dir, "smpls"))):
        p = os.path.join(data_dir, "smpls", f)
        with open(p, "rb") as fh:
            d = pickle.load(fh)
        d["global_orient"] *= 0.1
        d["body_pose"] *= 0.1
        d["betas"] *= 0.1
        d["transl"] = np.array([[0.0, 0.0, 2.5]], np.float32)
        write_pickle_file(p, d)
    xpose = str(tmp_path / "X_pose.pkl")
    write_pickle_file(xpose, {"betas": np.zeros((1, 10), np.float32),
                              "global_orient": np.zeros(3, np.float32),
                              "body_pose": np.zeros(69, np.float32),
                              "transl": np.zeros(3, np.float32)})
    prepare_template(str(tmp_path / "data"), "male-9-parity", gender="male",
                     model_path=str(tmp_path / "models"),
                     template_path=xpose, num_points=1500, device="cpu")

    cfg = get_default_config()
    cfg.merge_from_dict({
        "exp_name": "male-9-parity", "root_dir": data_dir,
        "model_path": str(tmp_path / "models"), "gender": "male",
        "img_wh": (W, H), "n_samples": 8, "n_importance": 4,
        "train": {"frame_start_ID": 1, "frame_end_ID": 4, "frame_skip": 1},
        "test": {"frame_start_ID": 5, "frame_end_ID": 6, "frame_skip": 1}})
    cfg = finalize(cfg)
    system = build_system(cfg, "cpu")
    sd = {}
    for net in ("nerf", "nerf_fine"):
        for name, p in getattr(system.scene, net).state_dict().items():
            layer, leaf = name.split(".")
            sd[f"anim_nerf.{net}.{_layer_name(layer)}.{leaf}"] = p.clone()
    for name, p in system.body_params.items():
        sd[f"body_model_params.{name}.weight"] = p.detach().clone()
    sd["anim_nerf.body_model.v_template"] = torch.zeros(240, 3)
    sd["evaluator.lpips.net.slice1.0.weight"] = torch.zeros(4, 3, 3, 3)
    ckpt = str(tmp_path / "last.ckpt")
    hparams = json.loads(json.dumps(cfg))
    _save_with_gone_class(lambda Cls: {
        "state_dict": sd, "epoch": 3, "global_step": 99,
        "hyper_parameters": dict(hparams, cfg_node=Cls())}, ckpt)

    want = jrun(data_dir, smpl_pkl, ckpt, ref_psnr=12.0, ref_ssim=0.5,
                out_dir=str(tmp_path / "jax_out"))
    jax.clear_caches()
    got = run_parity_check(data_dir, smpl_pkl, ckpt, ref_psnr=12.0,
                           ref_ssim=0.5, out_dir=str(tmp_path / "port_out"),
                           device="cpu")
    assert "lpips" not in got
    assert set(got) == {k for k in want if "lpips" not in k}
    assert np.isfinite(got["psnr"]) and abs(got["psnr"] - want["psnr"]) \
        <= 1e-4, (got, want)
    assert abs(got["ssim"] - want["ssim"]) <= 1e-4
    assert got["psnr_delta"] == pytest.approx(got["psnr"] - 12.0)
    assert got["ssim_delta"] == pytest.approx(got["ssim"] - 0.5)
    assert got["psnr_within_0.1dB"] == (abs(got["psnr"] - 12.0) <= 0.1)
    # the two command lines: the converter, then the parity check on the
    # converted directory, its printed report equal to the call's
    from animnerf_tpu_torch.tools import convert_checkpoint as CC
    from animnerf_tpu_torch.tools import parity_check as PC

    CC.main(["--ckpt_path", ckpt, "--out_dir", str(tmp_path / "cli_conv")])
    capsys.readouterr()
    PC.main(["--data_dir", data_dir, "--smpl_pkl", smpl_pkl, "--ckpt",
             str(tmp_path / "cli_conv"), "--ref_psnr", "12.0",
             "--out_dir", str(tmp_path / "cli_out"), "--device", "cpu"])
    printed = capsys.readouterr().out
    report = json.loads(printed[printed.index("{"):printed.rindex("}") + 1])
    assert report == {k: v for k, v in got.items() if "ssim_" not in k}
    assert "PSNR delta vs reference" in printed
    conv = _npz(str(tmp_path / "port_out" / "converted_ckpt"
                    / "anim_nerf.npz"))
    np.testing.assert_array_equal(
        conv["nerf/params/xyz_0/kernel"],
        system.scene.nerf.xyz_0.weight.detach().numpy().T)
